"""Delay policies: how a commit chooses the stale read point ``X_hat_k``
(port of ``repro.samplers.policies``).

- :class:`ConstantDelay` — worst-case fixed staleness ``tau``, with the
  can't-be-staler-than-``k`` warm-up built in.
- :class:`TraceDelay` — consistent (W-Con) whole-vector read at the
  realized staleness fed per step.
- :class:`PerCoordinateDelay` — inconsistent (W-Icon) per-coordinate read
  ``[X_hat]_i = [X_{s_i}]_i`` with ``s_i ~ U{0..tau_k}``; ``fused=True``
  draws the delays and gathers in one CUDA kernel a leaf on a card.

A policy reads C chains' stacked ring at once (C = 1 for a single chain):
chain c at its staleness ``ctx.delay[c]`` under its key
``ctx.key_delay[c]``, from its own head.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Protocol, runtime_checkable

from repro_torch.core.delay import (
    RingBuffer,
    read_consistent,
    read_inconsistent_leafwise,
)
from repro_torch.samplers.transform import StepContext

PyTree = Any


@runtime_checkable
class DelayPolicy(Protocol):
    """Chooses every chain's read point for one commit from the
    chain-stacked iterate history; ``tau`` is the maximum staleness (ring
    depth ``tau + 1``)."""

    tau: int

    def read(self, ctx: StepContext, ring: RingBuffer) -> PyTree:
        ...


@dataclass(frozen=True)
class ConstantDelay:
    """W-Con read at fixed staleness ``tau`` (clamped to the commit count)."""

    tau: int

    def read(self, ctx: StepContext, ring: RingBuffer) -> PyTree:
        """Whole-vector read ``X_{k - min(k, tau)}`` of every chain."""
        return read_consistent(ring, [min(ctx.step, self.tau)] * len(ctx.delay))


@dataclass(frozen=True)
class TraceDelay:
    """W-Con read at the realized per-commit staleness ``ctx.delay``."""

    tau: int

    def read(self, ctx: StepContext, ring: RingBuffer) -> PyTree:
        """Whole-vector read ``X_{k - ctx.delay[c]}`` of every chain c."""
        return read_consistent(ring, ctx.delay)


@dataclass(frozen=True)
class PerCoordinateDelay:
    """W-Icon read: each coordinate from its own snapshot in ``[k-tau_k, k]``."""

    tau: int
    fused: bool = False

    def read(self, ctx: StepContext, ring: RingBuffer) -> PyTree:
        """Per-coordinate read: chain c's coordinate staleness in ``[0,
        ctx.delay[c]]`` drawn from ``ctx.key_delay[c]`` (bit for bit the
        JAX package's draw), gathered from the ring one leaf at a time, one
        launch a leaf for every chain on a card (the one-pass
        ``wicon_read`` kernel when ``fused``)."""
        return read_inconsistent_leafwise(ring, ctx.key_delay, ctx.delay,
                                          fused=self.fused)
