"""Wasserstein-2 distances in PyTorch (port of ``repro.metrics.wasserstein``,
an offline stand-in for the POT library).

- ``w2_empirical_1d``  exact for 1-D empirical measures (sorted quantiles).
- ``gaussian_w2``      closed form between Gaussians (Bures metric).
- ``sinkhorn_w2``      entropy-regularized OT between point clouds, debiased;
                       converges to exact W2 as eps -> 0.
- ``w2_to_gaussian``   moment-matched surrogate used for the paper's
                       figures: fits a Gaussian to the iterate cloud and
                       takes the closed form against the target posterior.

Everything runs in float32 on the inputs' device, as the reference does;
the matrix square roots go through ``torch.linalg.eigh`` (cuSOLVER on a
card, LAPACK on the CPU).
"""

from __future__ import annotations

import math

import torch


def _atleast_1d(a) -> torch.Tensor:
    a = torch.as_tensor(a)
    return a.reshape(1) if a.dim() == 0 else a


def _atleast_2d(a) -> torch.Tensor:
    a = torch.as_tensor(a)
    return a.reshape(1, -1) if a.dim() < 2 else a


def w2_empirical_1d(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact W2 between two equal-size 1-D samples."""
    xs = torch.sort(x.reshape(-1)).values
    ys = torch.sort(y.reshape(-1)).values
    return torch.sqrt(torch.mean((xs - ys) ** 2))


def _sqrtm_psd(a: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD matrix square root via eigh."""
    w, v = torch.linalg.eigh(a)
    w = torch.clamp_min(w, 0.0)
    return (v * torch.sqrt(w)) @ v.T


def gaussian_w2(mu1, cov1, mu2, cov2) -> torch.Tensor:
    """Bures–Wasserstein: ||mu1-mu2||^2 + tr(C1 + C2 - 2 (C2^1/2 C1 C2^1/2)^1/2)."""
    mu1, mu2 = _atleast_1d(mu1), _atleast_1d(mu2)
    cov1, cov2 = _atleast_2d(cov1), _atleast_2d(cov2)
    s2 = _sqrtm_psd(cov2)
    cross = _sqrtm_psd(s2 @ cov1 @ s2)
    t = torch.trace(cov1) + torch.trace(cov2) - 2.0 * torch.trace(cross)
    return torch.sqrt(torch.clamp_min(torch.sum((mu1 - mu2) ** 2) + t, 0.0))


def w2_to_gaussian(samples: torch.Tensor, mu: torch.Tensor,
                   cov: torch.Tensor) -> torch.Tensor:
    """Moment-matched W2 of an iterate cloud (n, d) to a Gaussian target
    (the cloud's covariance with ddof 1, as ``jnp.cov``)."""
    m = torch.mean(samples, dim=0)
    c = _atleast_2d(torch.cov(samples.T))
    return gaussian_w2(m, c, mu, _atleast_2d(cov))


def _sinkhorn_cost(x, y, eps: float, num_iters: int) -> torch.Tensor:
    n, m = x.shape[0], y.shape[0]
    c = torch.sum((x[:, None, :] - y[None, :, :]) ** 2, dim=-1)
    log_a = torch.full((n,), -math.log(n), dtype=x.dtype, device=x.device)
    log_b = torch.full((m,), -math.log(m), dtype=x.dtype, device=x.device)
    f = torch.zeros(n, dtype=x.dtype, device=x.device)
    g = torch.zeros(m, dtype=x.dtype, device=x.device)
    for _ in range(num_iters):
        f = -eps * torch.logsumexp((g[None, :] - c) / eps + log_b[None, :], dim=1)
        g = -eps * torch.logsumexp((f[:, None] - c) / eps + log_a[:, None], dim=0)
    log_p = (f[:, None] + g[None, :] - c) / eps + log_a[:, None] + log_b[None, :]
    return torch.sum(torch.exp(log_p) * c)


def sinkhorn_w2(x: torch.Tensor, y: torch.Tensor, eps: float = 0.05,
                num_iters: int = 200, debias: bool = True) -> torch.Tensor:
    """Entropy-regularized W2 between point clouds x:(n,d), y:(m,d).

    With ``debias`` uses the Sinkhorn divergence S = OT(x,y) - (OT(x,x) +
    OT(y,y))/2, which removes the entropic bias and is ~exact for moderate eps.
    """
    cost_xy = _sinkhorn_cost(x, y, eps, num_iters)
    if not debias:
        return torch.sqrt(torch.clamp_min(cost_xy, 0.0))
    cost_xx = _sinkhorn_cost(x, x, eps, num_iters)
    cost_yy = _sinkhorn_cost(y, y, eps, num_iters)
    return torch.sqrt(torch.clamp_min(cost_xy - 0.5 * (cost_xx + cost_yy), 0.0))
