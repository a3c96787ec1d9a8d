"""Potentials U for the paper's experiments and for theory validation (port
of ``repro.core.potentials``).

The SGLD target is the Gibbs measure pi(x) ∝ exp(-U(x)/sigma).  Each
potential exposes:

  - ``value(params, batch)``     full/minibatch potential
  - ``grad(params, batch)``      stochastic gradient (autograd)
  - ``sample_batch(key, n)``     draw a data minibatch
  - strong-convexity / Lipschitz constants ``m``, ``L`` where defined
    (quadratic and regression; RICA is non-convex — the paper runs it
    anyway, outside the theory).

Tensors live on an explicit device: the one the ``make`` / ``init_params``
entry points are given (``"cuda"`` by default), or that of the tensors a
potential is built from.  Problems and minibatches are drawn with
:func:`~repro_torch.kernels.rng.jax_uniform` and
:func:`~repro_torch.kernels.rng.jax_normal`, so a key gives the JAX
package's problem and batches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import rng
from repro_torch.utils import resolve_device, tree_leaves

PyTree = Any


def _grad(value_fn, x: torch.Tensor, batch) -> torch.Tensor:
    """d value_fn(x, batch) / dx by autograd on a detached leaf."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(value_fn(leaf, batch), leaf)
    return g


def _to_f32(a, device) -> torch.Tensor:
    """A numpy result as float32 on ``device``, as ``jnp.asarray`` casts it."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


# ---------------------------------------------------------------------------
# Quadratic potential — closed-form stationary distribution.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Quadratic:
    """U(x) = 1/2 (x - x*)^T A (x - x*), A diagonal SPD.

    Langevin dX = -∇U dt + sqrt(2 sigma) dB has stationary N(x*, sigma A^-1).
    Stochastic gradients add N(0, grad_noise^2 I).
    """

    x_star: torch.Tensor
    diag: torch.Tensor
    grad_noise: float = 0.0

    @property
    def d(self) -> int:
        return int(self.x_star.shape[0])

    @property
    def m(self) -> float:
        return float(self.diag.min())

    @property
    def L(self) -> float:
        return float(self.diag.max())

    def value(self, x: torch.Tensor, batch=None) -> torch.Tensor:  # noqa: ARG002
        r = x - self.x_star
        return 0.5 * torch.sum(self.diag * r * r)

    def grad(self, x: torch.Tensor, batch=None, *, key=None) -> torch.Tensor:  # noqa: ARG002
        g = self.diag * (x - self.x_star)
        if self.grad_noise > 0.0 and key is not None:
            g = g + self.grad_noise * rng.jax_normal(key, g.shape, g.device)
        return g

    def sample_batch(self, key, n: int):  # noqa: ARG002
        return None

    def stationary_cov(self, sigma: float) -> torch.Tensor:
        return sigma / self.diag

    @staticmethod
    def make(key, d: int, m: float = 0.5, L: float = 2.0,
             grad_noise: float = 0.0, *, device="cuda") -> "Quadratic":
        dev = resolve_device(device)
        k1, k2 = rng.split(key)
        x_star = rng.jax_normal(k1, (d,), dev)
        if d == 1:
            diag = torch.full((1,), m, device=dev)
        else:
            diag = torch.cat([torch.tensor([m, L], device=dev),
                              rng.jax_uniform(k2, (d - 2,), m, L, dev)])
        return Quadratic(x_star=x_star, diag=diag, grad_noise=grad_noise)


# ---------------------------------------------------------------------------
# Polynomial regression — paper §3.2.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PolyRegression:
    """Bayesian linear regression on phi(z) = [z, z^2, z^3, z^4] (+ bias).

    A single linear layer with 4 input features and one output implementing
    a 4th degree polynomial regression, observation noise N(0, nu_std^2),
    data generated on the fly from the true polynomial.

    U(w) = N/(2 nu^2) E_batch[(w·phi + b - y)^2] + prior_prec/2 ||w||^2
    taken per-example (N=1 scaling) so that m, L are batch-independent.
    """

    true_coef: torch.Tensor         # (4,)
    true_bias: float
    nu_std: float = 0.1
    prior_prec: float = 1.0
    z_scale: float = 1.0

    @property
    def d(self) -> int:
        return 5

    @property
    def device(self) -> torch.device:
        return self.true_coef.device

    def features(self, z: torch.Tensor) -> torch.Tensor:
        # powers multiplied out as JAX's integer_pow does: z^3 = z * z^2,
        # z^4 = z^2 * z^2
        z2 = z * z
        return torch.stack([z, z2, z * z2, z2 * z2], dim=-1)

    def predict(self, w: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        """Model forward on feature rows: ``phi @ coef + bias`` (w = [coef,
        bias])."""
        return phi @ w[:4] + w[4]

    def sample_batch(self, key, n: int):
        kz, ke = rng.split(key)
        z = self.z_scale * rng.jax_uniform(kz, (n,), -1.0, 1.0, self.device)
        phi = self.features(z)
        y = (phi @ self.true_coef + self.true_bias
             + self.nu_std * rng.jax_normal(ke, (n,), self.device))
        return phi, y

    def value(self, w: torch.Tensor, batch) -> torch.Tensor:
        phi, y = batch
        r = self.predict(w, phi) - y
        fit = 0.5 / (self.nu_std**2) * torch.mean(r * r)
        return fit + 0.5 * self.prior_prec * torch.sum(w * w)

    def grad(self, w: torch.Tensor, batch, *, key=None) -> torch.Tensor:  # noqa: ARG002
        return _grad(self.value, w, batch)

    def _moments64(self, num: int, seed: int, sigma: float):
        rng_np = np.random.default_rng(seed)
        z = self.z_scale * rng_np.uniform(-1.0, 1.0, num)
        psi = np.stack([z, z**2, z**3, z**4, np.ones_like(z)], axis=-1)
        y = (
            psi[:, :4] @ self.true_coef.cpu().numpy()
            + self.true_bias
            + self.nu_std * rng_np.normal(size=num)
        )
        A = (psi.T @ psi) / num / self.nu_std**2 + self.prior_prec * np.eye(5)
        b = (psi.T @ y) / num / self.nu_std**2
        return np.linalg.solve(A, b), sigma * np.linalg.inv(A), A

    def posterior_moments(self, num: int = 200_000, seed: int = 0,
                          sigma: float = 1.0):
        """Gaussian posterior N(mu, sigma * Sigma) for the *per-example* U.

        U(w) = 1/(2 nu^2) E[(w·psi - y)^2] + prior/2 ||w||^2 with
        psi = [phi, 1]; quadratic in w with Hessian
        A = E[psi psi^T]/nu^2 + prior*I, so pi ∝ exp(-U/sigma) is
        N(A^-1 b, sigma A^-1).  Computed in float64 numpy, returned as
        float32 tensors on the potential's device.
        """
        return tuple(_to_f32(a, self.device)
                     for a in self._moments64(num, seed, sigma))

    def constants(self) -> tuple[float, float]:
        """(m, L) of the per-example expected potential."""
        A = np.asarray(self._moments64(100_000, 0, 1.0)[2], np.float32)
        ev = np.linalg.eigvalsh(A)
        return float(ev[0]), float(ev[-1])

    @staticmethod
    def make(key, nu_std: float = 0.1, *, device="cuda") -> "PolyRegression":
        dev = resolve_device(device)
        k1, k2 = rng.split(key)
        coef = rng.jax_normal(k1, (4,), dev)
        bias = float(rng.jax_normal(k2, (), dev))
        return PolyRegression(true_coef=coef, true_bias=bias, nu_std=nu_std)


# ---------------------------------------------------------------------------
# Reconstruction ICA — paper §3.3 (non-convex; outside the theory).
# min_W  lambda ||W x||_1 + 1/2 ||W^T W x - x||^2.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RICA:
    """RICA on image patches.  W has shape (num_features, patch_dim); the
    patches are drawn on ``device``."""

    patch_dim: int
    num_features: int
    lam: float = 0.4
    device: Any = "cuda"

    @property
    def d(self) -> int:
        return self.num_features * self.patch_dim

    def init_params(self, key) -> torch.Tensor:
        w = rng.jax_normal(key, (self.num_features, self.patch_dim),
                           resolve_device(self.device))
        return w / torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))

    def sample_batch(self, key, n: int) -> torch.Tensor:
        """Synthetic natural-image-statistics patches: a 1/f amplitude
        spectrum under uniform random phases (the offline stand-in for
        CIFAR-10 patches).  The inverse FFT is ``torch.fft.ifft2``."""
        dev = resolve_device(self.device)
        side = int(math.isqrt(self.patch_dim))
        if side * side != self.patch_dim:
            raise ValueError(f"patch_dim {self.patch_dim} must be a square")
        freq = torch.fft.fftfreq(side, dtype=torch.float32, device=dev)
        f2 = freq[:, None] ** 2 + freq[None, :] ** 2
        amp = torch.where(f2 > 0, 1.0 / torch.sqrt(f2), torch.zeros_like(f2))
        phase = rng.jax_uniform(key, (n, side, side), 0.0, 2 * math.pi, dev)
        spec = amp[None] * torch.polar(torch.ones_like(phase), phase)
        img = torch.fft.ifft2(spec).real
        img = img - torch.mean(img, dim=(1, 2), keepdim=True)
        img = img / (torch.std(img, dim=(1, 2), keepdim=True, correction=0)
                     + 1e-8)
        return img.reshape(n, self.patch_dim)

    def value(self, w: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
        x = batch  # (n, patch_dim)
        wx = x @ w.T  # (n, num_features)
        recon = wx @ w  # (n, patch_dim)
        sparse = self.lam * torch.mean(torch.sum(torch.abs(wx), dim=-1))
        r = recon - x
        fit = 0.5 * torch.mean(torch.sum(r * r, dim=-1))
        return sparse + fit

    def grad(self, w: torch.Tensor, batch, *, key=None) -> torch.Tensor:  # noqa: ARG002
        return _grad(self.value, w, batch)


def neg_log_posterior_potential(loss_fn, prior_prec: float = 0.0):
    """Wrap an arbitrary model loss into a potential U for SGLD on trees."""

    def u(params, batch):
        val = loss_fn(params, batch)
        if prior_prec > 0.0:
            sq = sum(torch.sum(p * p) for p in tree_leaves(params))
            val = val + 0.5 * prior_prec * sq
        return val

    return u
