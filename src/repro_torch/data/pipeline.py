"""Data streams for the sampler zoo (port of ``repro.data.pipeline``'s
:func:`ar1_stream`; the prefetcher is not ported yet).

:func:`ar1_stream` generates the dependent (non-i.i.d.) minibatch sequence
of the Chau-et-al.-shaped scenario, with its normals drawn by
:func:`~repro_torch.kernels.rng.jax_normal`, so a key gives the JAX
package's stream.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import rng
from repro_torch.utils import resolve_device


def ar1_stream(key, *, steps: int, batch: int, d: int, rho: float = 0.9,
               mean: float = 0.0, scale: float = 1.0, device="cuda") -> torch.Tensor:
    """A dependent AR(1) minibatch sequence: each of the ``batch * d``
    example coordinates follows its own stationary AR(1) chain,

        e_{t+1} = mean + rho * (e_t - mean) + scale * sqrt(1 - rho^2) * xi_t,

    with ``e_0`` from the stationary marginal ``N(mean, scale^2)``, so every
    step's marginal is that of an i.i.d. ``N(mean, scale^2)`` stream and
    only the temporal dependence changes.  ``key`` is a ``(k0, k1)`` key:
    ``e_0`` is drawn under ``split(key)[0]`` and the innovations under
    ``split(key)[1]``, as the JAX package draws them in float32.
    Returns ``(steps, batch, d)`` float32 on ``device`` (the card by
    default).
    """
    if not 0.0 <= rho < 1.0:
        raise ValueError(f"rho must be in [0, 1), got {rho}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = resolve_device(device)
    k0, k_noise = rng.split(key)
    f32 = lambda v: torch.tensor(np.float32(v), device=dev)  # noqa: E731
    mean_t, rho_t = f32(mean), f32(rho)
    e = mean_t + f32(scale) * rng.jax_normal(k0, (batch, d), dev)
    out = torch.empty((steps, batch, d), dtype=torch.float32, device=dev)
    out[0] = e
    if steps > 1:
        xi = rng.jax_normal(k_noise, (steps - 1, batch, d), dev)
        innov = f32(scale * math.sqrt(1.0 - rho ** 2))
        for t in range(steps - 1):
            # the multiply-adds XLA fuses on the CPU, rounded once (a zero
            # mean folds away first)
            if mean == 0.0:
                e = rng._fma(rho_t, e, innov * xi[t])
            else:
                e = rng._fma(innov, xi[t], rng._fma(rho_t, e - mean_t, mean_t))
            out[t + 1] = e
    return out
