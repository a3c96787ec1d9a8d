"""KL divergence estimators, the paper's second convergence metric (port
of ``repro.metrics.kl``; float32, ``torch.linalg`` on the inputs' device)."""

from __future__ import annotations

import math

import torch

from repro_torch.metrics.wasserstein import _atleast_1d, _atleast_2d


def gaussian_kl(mu1, cov1, mu2, cov2) -> torch.Tensor:
    """KL(N(mu1,cov1) || N(mu2,cov2)) closed form."""
    mu1, mu2 = _atleast_1d(mu1), _atleast_1d(mu2)
    cov1, cov2 = _atleast_2d(cov1), _atleast_2d(cov2)
    d = mu1.shape[0]
    c2inv = torch.linalg.inv(cov2)
    diff = mu2 - mu1
    term_tr = torch.trace(c2inv @ cov1)
    term_quad = diff @ c2inv @ diff
    ld1 = torch.linalg.slogdet(cov1).logabsdet
    ld2 = torch.linalg.slogdet(cov2).logabsdet
    return 0.5 * (term_tr + term_quad - d + ld2 - ld1)


def kl_samples_to_gaussian(samples: torch.Tensor, mu, cov) -> torch.Tensor:
    """Moment-matched KL of an iterate cloud to a Gaussian target."""
    m = torch.mean(samples, dim=0)
    c = _atleast_2d(torch.cov(samples.T))
    c = c + 1e-9 * torch.eye(c.shape[0], dtype=c.dtype, device=c.device)
    return gaussian_kl(m, c, _atleast_1d(mu), _atleast_2d(cov))


def knn_kl_estimate(x: torch.Tensor, y: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Nonparametric k-NN KL(P||Q) estimator (Wang et al. 2009) between
    samples x ~ P (n, d) and y ~ Q (m, d)."""
    n, d = x.shape
    m = y.shape[0]

    def kth_dist(a, b, skip_self):
        d2 = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)
        if skip_self:
            eye = torch.eye(a.shape[0], b.shape[0], dtype=torch.bool,
                            device=a.device)
            d2 = d2 + torch.where(eye, math.inf, 0.0)
        vals = torch.topk(d2, k, dim=1, largest=False).values[:, -1]
        return torch.sqrt(torch.clamp_min(vals, 1e-30))

    rho = kth_dist(x, x, skip_self=True)
    nu = kth_dist(x, y, skip_self=False)
    return d * torch.mean(torch.log(nu / rho)) + math.log(m / (n - 1.0))
