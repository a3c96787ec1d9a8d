"""Deprecated string-dispatched SGLD front end — use
:mod:`repro_torch.samplers` (port of ``repro.core.sgld``).

``SGLDSampler`` is a thin shim over the composable sampler-transform API:
``SGLDConfig(mode=...)`` maps one-to-one onto the
``samplers.sgld(mode=...)`` presets (:func:`~repro_torch.samplers.presets.
from_config`), and the trajectories are bit-identical because both front
ends run the same chain.

Update rule (paper eq. (4)):

    X_{k+1} = X_k - gamma_k * grad U(X_hat_k) + sqrt(2 sigma gamma_k) * G_k

with four read models for ``X_hat_k``: ``sync`` (X_hat = X_k),
``consistent`` (W-Con whole-vector stale read), ``inconsistent`` (W-Icon
per-coordinate read), ``pipeline`` (previous gradient; its all-reduce
overlaps the next step's compute).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.schedules import Schedule
# The leafwise update math lives in the composable API; these aliases keep
# the reference's import sites (launch/steps.py, benchmarks) working.
from repro_torch.samplers.base import Sampler, SamplerState
from repro_torch.samplers.transforms import noise_like as langevin_noise  # noqa: F401
from repro_torch.samplers.transforms import sgld_apply as apply_update  # noqa: F401
from repro_torch.utils import tree_flatten, tree_unflatten

PyTree = Any
GradFn = Callable[..., PyTree]  # grad_fn(params, batch) -> pytree of grads

#: Deprecated alias — transform state lives in ``state.inner``.
SGLDState = SamplerState


@dataclass(frozen=True)
class SGLDConfig:
    mode: str = "sync"  # sync | consistent | inconsistent | pipeline
    gamma: float | Schedule = 1e-2
    sigma: float = 1.0  # temperature (paper's sigma; nu^2 of injected noise)
    tau: int = 0        # max delay == ring depth - 1 (consistent/inconsistent)
    noise_dtype: Any = torch.float32

    def __post_init__(self):
        if self.mode not in ("sync", "consistent", "inconsistent", "pipeline"):
            raise ValueError(f"unknown SGLD mode {self.mode!r}")
        if self.mode in ("consistent", "inconsistent") and self.tau < 1:
            raise ValueError(f"mode {self.mode!r} needs tau >= 1")

    def gamma_at(self, step: int) -> np.float32:
        """Step size at commit ``step`` as a float32: the schedule there,
        or the constant ``gamma``."""
        if callable(self.gamma):
            return np.float32(self.gamma(step))
        return np.float32(self.gamma)


class SGLDSampler:
    """Deprecated shim: delegates to ``repro_torch.samplers.sgld(mode=...)``.

    ``grad_fn(params, batch)`` may return either a gradient pytree or a
    ``(grads, aux)`` tuple; aux (e.g. the loss) is surfaced by ``step``.
    """

    def __init__(self, config: SGLDConfig, grad_fn: GradFn, has_aux: bool = False):
        warnings.warn(
            "SGLDSampler is deprecated; build the equivalent preset with "
            "repro_torch.samplers.sgld(mode=...) (or compose transforms with "
            "repro_torch.samplers.chain).",
            DeprecationWarning, stacklevel=2)
        from repro_torch.samplers.presets import from_config  # lazy: import cycle

        self.config = config
        self.grad_fn = grad_fn
        self.has_aux = has_aux
        self._sampler: Sampler = from_config(config, grad_fn, has_aux)

    # -- delegation ----------------------------------------------------------
    def init(self, params: PyTree, key) -> SamplerState:
        return self._sampler.init(params, key)

    def step(self, state: SamplerState, batch, delay_k: int = 0):
        """One SGLD commit; ``delay_k`` is the realized staleness tau_k."""
        return self._sampler.step(state, batch, delay_k)

    def run(self, state: SamplerState, batches, delays, *, collect: bool = True):
        return self._sampler.run(state, batches, delays, collect=collect)


def make_minibatch_grad(potential):
    """grad U from a potential object (autograd through ``potential.value``,
    leafwise over a pytree of parameters)."""

    def grad_fn(params, batch):
        leaves, treedef = tree_flatten(params)
        xs = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            value = potential.value(tree_unflatten(treedef, xs), batch)
            grads = torch.autograd.grad(value, xs)
        return tree_unflatten(treedef, list(grads))

    return grad_fn
