"""One-line presets: the paper's SGLD as transform chains (port of
``repro.samplers.presets``'s ``sgld`` and ``from_config``).

    sampler = samplers.sgld("consistent", grad_fn, gamma=1e-2, sigma=0.5, tau=4)

is exactly

    Sampler(chain(delay_read(TraceDelay(tau)),
                  gradients(grad_fn),
                  langevin_noise(sigma),
                  apply_sgld_update()),
            gamma=gamma)
"""

from __future__ import annotations

import torch

from repro_torch.samplers.base import Sampler
from repro_torch.samplers.policies import DelayPolicy, PerCoordinateDelay, TraceDelay
from repro_torch.samplers.transform import SamplerTransform, chain
from repro_torch.samplers.transforms import (
    GradFn,
    apply_sgld_update,
    delay_read,
    fused_update,
    gradients,
    langevin_noise,
    pipeline_overlap,
)

MODES = ("sync", "consistent", "inconsistent", "pipeline")


def sgld(mode: str, grad_fn: GradFn, *, gamma=1e-2, sigma: float = 1.0,
         tau: int = 0, has_aux: bool = False,
         delay_policy: DelayPolicy | None = None, fused: bool = False,
         noise_dtype=torch.float32) -> Sampler:
    """The paper's SGLD in any of its four read models.

    - ``sync``         X_hat = X_k (barrier baseline; tau = 0).
    - ``consistent``   X_hat = X_{k - tau_k} whole-vector stale read (W-Con).
    - ``inconsistent`` [X_hat]_i = [X_{s_i}]_i per-coordinate read (W-Icon).
    - ``pipeline``     previous step's gradient (tau = 1 W-Con on gradients).

    ``fused=True`` commits through the fused Langevin kernel (noise made in
    the kernel) and, in W-Icon mode, reads through the delay kernels;
    ``delay_policy`` overrides the mode's default policy.
    """
    if mode not in MODES:
        raise ValueError(f"unknown sampler mode {mode!r}")
    if mode in ("consistent", "inconsistent") and delay_policy is None \
            and tau < 1:
        raise ValueError(f"mode {mode!r} needs tau >= 1")
    parts: list[SamplerTransform] = []
    if mode in ("consistent", "inconsistent"):
        if delay_policy is None:
            delay_policy = (PerCoordinateDelay(tau, fused=fused)
                            if mode == "inconsistent" else TraceDelay(tau))
        parts.append(delay_read(delay_policy))
    parts.append(gradients(grad_fn, has_aux=has_aux))
    if mode == "pipeline":
        parts.append(pipeline_overlap())
    if fused:
        parts.append(fused_update(sigma))
    else:
        parts.append(langevin_noise(sigma, noise_dtype=noise_dtype))
        parts.append(apply_sgld_update())
    return Sampler(transform=chain(*parts), gamma=gamma)


def from_config(cfg, grad_fn: GradFn, has_aux: bool = False, *,
                fused: bool = False) -> Sampler:
    """Build the preset matching an ``SGLDConfig`` (duck-typed)."""
    return sgld(cfg.mode, grad_fn, gamma=cfg.gamma, sigma=cfg.sigma,
                tau=cfg.tau, has_aux=has_aux, fused=fused,
                noise_dtype=getattr(cfg, "noise_dtype", torch.float32))
