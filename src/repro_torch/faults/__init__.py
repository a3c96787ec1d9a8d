"""repro_torch.faults — deterministic fault injection and self-healing
(port of ``repro.faults``): one vocabulary over the fault surface, each
primitive living next to the subsystem it stresses.

- :class:`FaultPlan` (:mod:`repro_torch.core.delay_model`) — worker chaos
  schedules: crash and pause events compiled into the
  :class:`~repro_torch.cluster.schedule.WorkerSchedule` a healthy cluster
  replays, with a per-commit liveness mask
  (:func:`~repro_torch.cluster.schedule.stack_liveness`); a lost commit is
  a masked no-op (the kernel skips the chain's row, its ring does not
  push), and a zero-rate plan is bitwise no plan.
- :class:`HealthState` (:mod:`repro_torch.cluster.executor`) — the sticky
  per-chain quarantine mask: a chain whose iterate goes non-finite stops
  committing, drops out of the ensemble reductions
  (:func:`~repro_torch.cluster.ensemble.healthy_chains`) and is respawned
  at the next chunk boundary from a healthy donor with a
  ``fold_in``-freshened key.  :func:`nan_storm` builds the poison masks
  that drive it.
- :class:`CorruptCheckpointError` (:mod:`repro_torch.checkpoint.io`) — a
  truncated or bit-flipped checkpoint fails loudly, naming the damaged
  leaf; :meth:`ClusterEngine.resume` continues a killed run bitwise.
- :class:`QueueFullError` and deadline shedding
  (:mod:`repro_torch.cluster.api`, :mod:`repro_torch.cluster.paged`) — the
  serving side: bounded queues reject, expired requests are shed
  (:data:`STATUS_SHED`) or cut short (:data:`STATUS_TIMEOUT`), and
  ``BankEngine.from_cluster`` serves a partly quarantined bank from its
  healthy chains.

Everything is counted: ``faults.injected``, ``chains.quarantined``,
``chains.respawned`` and ``chains.unhealthy`` in the metrics registry, and
``faults.respawn`` spans on the tracer.
"""

from __future__ import annotations

import numpy as np

from repro_torch.checkpoint.io import CorruptCheckpointError  # noqa: F401
from repro_torch.cluster.api import (  # noqa: F401
    STATUS_OK,
    STATUS_SHED,
    STATUS_TIMEOUT,
    QueueFullError,
)
from repro_torch.cluster.executor import HealthState  # noqa: F401
from repro_torch.cluster.schedule import stack_liveness  # noqa: F401
from repro_torch.core.delay_model import FaultPlan  # noqa: F401

__all__ = [
    "CorruptCheckpointError",
    "FaultPlan",
    "HealthState",
    "QueueFullError",
    "STATUS_OK",
    "STATUS_SHED",
    "STATUS_TIMEOUT",
    "nan_storm",
    "stack_liveness",
]


def nan_storm(steps: int, num_chains: int, *, rate: float = 0.01,
              seed: int = 0) -> np.ndarray:
    """A ``(steps, num_chains)`` bool poison mask: a True cell NaNs that
    chain's iterate after that commit's update.

    Feed it to :meth:`ClusterEngine.run(..., poison=...)
    <repro_torch.cluster.executor.ClusterEngine.run>` (with
    ``health_check=True``) to drive quarantine and respawn; the same seed
    gives the JAX package's mask (its own ``numpy`` stream, salted, so a
    storm perturbs no schedule or sampler randomness).  ``rate`` is the
    poison probability a commit and chain."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"rate must be in [0, 1], got {rate}")
    rng = np.random.default_rng((seed, 0x5A17))
    return rng.random((steps, num_chains)) < rate
