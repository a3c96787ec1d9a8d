"""Step-size schedules: constant, polynomial decay, warmup, WSD (port of
``repro.core.schedules``).

A schedule maps the commit counter ``k`` (a host int) to the step size
``gamma_k`` as a numpy float32 — computed on the host in float32, as the
JAX schedules compute it on the device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], np.float32]

_f = np.float32


def constant(value: float) -> Schedule:
    return lambda step: _f(value)


def poly_decay(gamma0: float, alpha: float = 0.5, t0: float = 1.0) -> Schedule:
    """gamma_k = gamma0 / (t0 + k)^alpha — the classic SGLD decreasing schedule."""
    return lambda step: _f(gamma0) / (_f(t0) + _f(step)) ** _f(alpha)


def linear_warmup(base: Schedule, warmup_steps: int) -> Schedule:
    def sched(step):
        scale = min(_f(1.0), (_f(step) + _f(1.0)) / _f(max(warmup_steps, 1)))
        return _f(scale * base(step))

    return sched


def wsd(peak: float, warmup_steps: int, stable_steps: int, decay_steps: int,
        final_frac: float = 0.1) -> Schedule:
    """Warmup-Stable-Decay (MiniCPM)."""

    def sched(step):
        s = _f(step)
        if s < warmup_steps:
            return _f(peak) * (s + _f(1.0)) / _f(max(warmup_steps, 1))
        in_decay = np.clip((s - _f(warmup_steps) - _f(stable_steps))
                           / _f(max(decay_steps, 1)), _f(0.0), _f(1.0))
        return _f(peak) * (_f(1.0) - (_f(1.0) - _f(final_frac)) * in_decay)

    return sched


def clip_to_theory(base: Schedule, gamma_max: float) -> Schedule:
    """Enforce the Corollary 2.1 ceiling on any schedule."""
    return lambda step: min(base(step), _f(gamma_max))
