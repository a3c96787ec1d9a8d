"""One-line presets: the sampler zoo as transform chains (port of
``repro.samplers.presets``: ``sgld``, ``svrg``, ``sghmc``, ``from_config``).

    sampler = samplers.sgld("consistent", grad_fn, gamma=1e-2, sigma=0.5, tau=4)

is exactly

    Sampler(chain(delay_read(TraceDelay(tau)),
                  gradients(grad_fn),
                  langevin_noise(sigma),
                  apply_sgld_update()),
            gamma=gamma)

:func:`svrg` swaps the gradient stage for the control-variate oracle,
:func:`sghmc` the commit pair for the momentum commit, and every preset
takes ``stale_strength`` / ``stale_gamma_scale`` (the stale-gradient
correction) and ``base_batch`` (per-example oracles over masked windows).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.samplers.base import Sampler
from repro_torch.samplers.policies import DelayPolicy, PerCoordinateDelay, TraceDelay
from repro_torch.samplers.transform import SamplerTransform, chain
from repro_torch.samplers.transforms import (
    GradFn,
    apply_sgld_update,
    batch_scaled_gamma,
    delay_read,
    fused_update,
    gradients,
    langevin_noise,
    masked_gradients,
    pipeline_overlap,
    sghmc_update,
    stale_correction,
    svrg_gradients,
)

MODES = ("sync", "consistent", "inconsistent", "pipeline")


def _front_parts(mode: str, *, tau: int, delay_policy: DelayPolicy | None,
                 fused: bool) -> list[SamplerTransform]:
    """The read-model head shared by every preset: validates ``mode`` /
    ``tau`` and returns the (possibly empty) ``delay_read`` stage."""
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
    return parts


def _stale_parts(stale_strength: float | None,
                 stale_gamma_scale: float) -> list[SamplerTransform]:
    """The optional Chen-et-al. correction stage (after the gradients)."""
    if stale_strength is None and stale_gamma_scale == 0.0:
        return []
    return [stale_correction(strength=(stale_strength or 0.0),
                             gamma_scale=stale_gamma_scale)]


def _grad_parts(grad_fn: GradFn, has_aux: bool,
                base_batch: int | None) -> list[SamplerTransform]:
    """The gradient stage: a minibatch oracle, or under ``base_batch`` a
    per-example oracle over masked windows with the step size scaled by
    ``size / base_batch``."""
    if base_batch is None:
        return [gradients(grad_fn, has_aux=has_aux)]
    return [batch_scaled_gamma(base_batch),
            masked_gradients(grad_fn, has_aux=has_aux)]


def sgld(mode: str, grad_fn: GradFn, *, gamma=1e-2, sigma: float = 1.0,
         tau: int = 0, has_aux: bool = False,
         delay_policy: DelayPolicy | None = None, fused: bool = False,
         noise_dtype=torch.float32, noise: str = "torch",
         base_batch: int | None = None, stale_strength: float | None = None,
         stale_gamma_scale: float = 0.0) -> Sampler:
    """The paper's SGLD in any of its four read models.

    - ``sync``         X_hat = X_k (barrier baseline; tau = 0).
    - ``consistent``   X_hat = X_{k - tau_k} whole-vector stale read (W-Con).
    - ``inconsistent`` [X_hat]_i = [X_{s_i}]_i per-coordinate read (W-Icon).
    - ``pipeline``     previous step's gradient (tau = 1 W-Con on gradients).

    ``fused=True`` commits through the fused Langevin kernel (noise made in
    the kernel) and, in W-Icon mode, reads through the delay kernels;
    ``delay_policy`` overrides the mode's default policy; ``noise`` picks
    the unfused draw (``"torch"`` or ``"jax"``, see ``noise_like``).

    ``base_batch`` switches to the heterogeneous-minibatch contract:
    ``grad_fn(params, example)`` becomes a *per-example* oracle evaluated
    by ``masked_gradients`` over the executor's bucket-padded
    ``MaskedBatch`` views, and the step size is scaled by ``size /
    base_batch``.  ``stale_strength`` / ``stale_gamma_scale`` splice the
    Chen-et-al. ``stale_correction`` in after the gradient stage (a bitwise
    no-op on commits with staleness 0).
    """
    parts = _front_parts(mode, tau=tau, delay_policy=delay_policy, fused=fused)
    parts += _grad_parts(grad_fn, has_aux, base_batch)
    parts += _stale_parts(stale_strength, stale_gamma_scale)
    if mode == "pipeline":
        parts.append(pipeline_overlap())
    if fused:
        parts.append(fused_update(sigma))
    else:
        parts.append(langevin_noise(sigma, noise_dtype=noise_dtype, noise=noise))
        parts.append(apply_sgld_update())
    return Sampler(transform=chain(*parts), gamma=gamma)


def svrg(mode: str, grad_fn: GradFn, full_grad_fn: Callable[[Any], Any], *,
         anchor_every: int = 64, gamma=1e-2, sigma: float = 1.0, tau: int = 0,
         has_aux: bool = False, delay_policy: DelayPolicy | None = None,
         noise_dtype=torch.float32, noise: str = "torch",
         base_batch: int | None = None, stale_strength: float | None = None,
         stale_gamma_scale: float = 0.0) -> Sampler:
    """SVRG-Langevin under any read model: :func:`sgld` with the gradient
    stage swapped for ``svrg_gradients`` (``full_grad_fn(params)``: the
    full-data gradient at the anchor, refreshed every ``anchor_every``
    commits; ``grad_fn`` a minibatch oracle, or per-example under
    ``base_batch``).  Unfused commit."""
    parts = _front_parts(mode, tau=tau, delay_policy=delay_policy, fused=False)
    if base_batch is not None:
        parts.append(batch_scaled_gamma(base_batch))
    parts.append(svrg_gradients(grad_fn, full_grad_fn,
                                anchor_every=anchor_every, has_aux=has_aux))
    parts += _stale_parts(stale_strength, stale_gamma_scale)
    if mode == "pipeline":
        parts.append(pipeline_overlap())
    parts.append(langevin_noise(sigma, noise_dtype=noise_dtype, noise=noise))
    parts.append(apply_sgld_update())
    return Sampler(transform=chain(*parts), gamma=gamma)


def sghmc(mode: str, grad_fn: GradFn, *, gamma=1e-2, sigma: float = 1.0,
          friction: float = 1.0, precond: Any = None, tau: int = 0,
          has_aux: bool = False, delay_policy: DelayPolicy | None = None,
          noise_dtype=torch.float32, noise: str = "torch",
          base_batch: int | None = None, stale_strength: float | None = None,
          stale_gamma_scale: float = 0.0) -> Sampler:
    """Stochastic-gradient HMC under any read model: :func:`sgld` with the
    noise-and-commit pair swapped for the momentum commit
    ``sghmc_update`` (``friction``: the drag; ``precond``: a diagonal
    inverse-mass preconditioner, scalar or params-shaped tree)."""
    parts = _front_parts(mode, tau=tau, delay_policy=delay_policy, fused=False)
    parts += _grad_parts(grad_fn, has_aux, base_batch)
    parts += _stale_parts(stale_strength, stale_gamma_scale)
    if mode == "pipeline":
        parts.append(pipeline_overlap())
    parts.append(sghmc_update(sigma, friction=friction, precond=precond,
                              noise_dtype=noise_dtype, noise=noise))
    return Sampler(transform=chain(*parts), gamma=gamma)


def from_config(cfg, grad_fn: GradFn, has_aux: bool = False, *,
                fused: bool = False) -> Sampler:
    """Build the preset matching an ``SGLDConfig`` (duck-typed)."""
    return sgld(cfg.mode, grad_fn, gamma=cfg.gamma, sigma=cfg.sigma,
                tau=cfg.tau, has_aux=has_aux, fused=fused,
                noise_dtype=getattr(cfg, "noise_dtype", torch.float32))
