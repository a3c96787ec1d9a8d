"""The composable sampler-transform protocol: optax-style ``(init, update)``
(port of ``repro.samplers.transform``).

A :class:`SamplerTransform` is a pair of functions threaded by the
:class:`~repro_torch.samplers.base.Sampler`:

- ``init(params) -> state`` builds one chain's state of the transform (a
  ring buffer of iterates, a pending gradient, or ``()``).
- ``update(ctx, state) -> (ctx, state)`` reads and rewrites fields of the
  per-step :class:`StepContext` — the read point ``x_hat``, the gradient,
  the Langevin noise, or the committed ``params`` — and advances its state.

``chain(*transforms)`` composes transforms left-to-right into one
transform whose state is the tuple of member states.

Chains on a leading axis.  The JAX package advances C chains with
``jax.vmap(sampler.step)``; ``torch.func.vmap`` cannot batch the port's
hand-written kernels, so ``update`` takes C chains stacked: the tensors
of ``params``, ``x_hat``, ``grads``, ``noise``, ``aux`` and of the
transform's state carry a leading chain axis C; ``gamma`` and ``delay``
are ``(C,)`` numpy arrays; ``key_noise`` and ``key_delay`` are lists of C
keys; ``batch`` is a list of C batches; ``step`` is one int (the commit
counter advances for every chain, a masked commit too).  ``skip`` (a
``(C,)`` host bool array, or None) marks the chains whose commit is
masked (a lost commit, a quarantined chain): the ring does not push them
and the fused commit leaves their rows alone; with ``check`` the fused
commit reports non-finite chains in ``nonfinite``.  A single chain is
C = 1 (:meth:`Sampler.step` views its state so, with :func:`one_chain`).
Chain ``c``'s result does not depend on C.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

PyTree = Any


class StepContext(NamedTuple):
    """Everything one SGLD commit of C chains can read or rewrite; built
    fresh by the sampler each step."""

    params: PyTree               # current iterates X_k, (C, ...) leaves
    x_hat: PyTree                # gradient read points (rewritten by delay_read)
    grads: Optional[PyTree]      # set by the gradients stage
    noise: Optional[PyTree]      # set by langevin_noise
    aux: Any                     # metrics surfaced by the gradients stage
    gamma: np.ndarray            # (C,) float32 step sizes gamma_k
    key_noise: list              # C per-step keys for Langevin noise
    key_delay: list              # C per-step keys for coordinate delays
    step: int                    # commit counter k
    delay: np.ndarray            # (C,) realized staleness tau_k of this commit
    batch: list                  # C opaque payloads for the gradient oracle
    skip: Optional[np.ndarray] = None       # (C,) bool: chains masked this commit
    check: bool = False                     # report non-finite chains
    nonfinite: Optional[torch.Tensor] = None  # (C,) int32, set by the fused commit


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


# ---------------------------------------------------------------------------
# chain-stacked trees: the port's stand-in for jax.vmap
# ---------------------------------------------------------------------------
def map_tensors(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of same-structured state trees (dicts,
    lists, tuples, named tuples, dataclasses such as a ring buffer); any
    other value (an int, None) must be equal across the trees — a ring's
    depth — and is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name),
                                *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if any(r is not tree and r != tree for r in rest):
        raise ValueError(f"chains disagree on a non-tensor value: {tree!r} vs {rest}")
    return tree


def chain_at(tree: Any, c: int) -> Any:
    """Chain ``c`` of a chain-stacked tree: every tensor indexed ``[c]``
    (a view)."""
    return map_tensors(lambda t: t[c], tree)


def one_chain(tree: Any) -> Any:
    """One chain's tree as a chain-stacked tree of C = 1: every tensor
    viewed with a leading axis of 1 (in-place updates reach the original)."""
    return map_tensors(lambda t: t.unsqueeze(0), tree)


def stack_chains(parts: list) -> Any:
    """Stack per-chain trees along a new leading chain axis (the inverse of
    :func:`chain_at`); one chain's tree is viewed, not copied."""
    if len(parts) == 1:
        return one_chain(parts[0])
    return map_tensors(lambda *ts: torch.stack(ts), *parts)
