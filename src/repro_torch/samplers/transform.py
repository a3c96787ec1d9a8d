"""The composable sampler-transform protocol: optax-style ``(init, update)``
(port of ``repro.samplers.transform``).

A :class:`SamplerTransform` is a pair of functions threaded by the
:class:`~repro_torch.samplers.base.Sampler`:

- ``init(params) -> state`` builds the transform's own state (a ring
  buffer of iterates, a pending gradient, or ``()``).
- ``update(ctx, state) -> (ctx, state)`` reads and rewrites fields of the
  per-step :class:`StepContext` — the read point ``x_hat``, the gradient,
  the Langevin noise, or the committed ``params`` — and advances its state.

``chain(*transforms)`` composes transforms left-to-right into one
transform whose state is the tuple of member states.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np

PyTree = Any


class StepContext(NamedTuple):
    """Everything one SGLD commit can read or rewrite; built fresh by the
    sampler each step."""

    params: PyTree               # current iterate X_k (rewritten by apply stages)
    x_hat: PyTree                # gradient read point (rewritten by delay_read)
    grads: Optional[PyTree]      # set by the gradients stage
    noise: Optional[PyTree]      # set by langevin_noise
    aux: Any                     # metrics surfaced by the gradients stage
    gamma: np.float32            # step size gamma_k (schedule-evaluated)
    key_noise: tuple             # per-step key for Langevin noise
    key_delay: tuple             # per-step key for coordinate delays
    step: int                    # commit counter k
    delay: int                   # realized staleness tau_k for this commit
    batch: Any                   # opaque payload handed to the gradient oracle


InitFn = Callable[[PyTree], Any]
UpdateFn = Callable[[StepContext, Any], tuple[StepContext, Any]]


class SamplerTransform(NamedTuple):
    """An optax-style (init, update) pair over :class:`StepContext`."""

    init: InitFn
    update: UpdateFn


def stateless(update_ctx: Callable[[StepContext], StepContext]) -> SamplerTransform:
    """Lift a ``ctx -> ctx`` function into a stateless transform."""

    def init(params):
        del params
        return ()

    def update(ctx, state):
        return update_ctx(ctx), state

    return SamplerTransform(init, update)


def chain(*transforms: SamplerTransform) -> SamplerTransform:
    """Compose transforms left-to-right; state is the tuple of member states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(ctx, state):
        new_state = []
        for t, s in zip(transforms, state):
            ctx, s = t.update(ctx, s)
            new_state.append(s)
        return ctx, tuple(new_state)

    return SamplerTransform(init, update)
