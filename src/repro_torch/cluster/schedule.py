"""Executable worker schedules: the compiled form of a :class:`DelayTrace`
(a numpy copy of ``repro.cluster.schedule``: the port imports nothing of
``repro``; pinned array for array, bitwise, by
``tests/test_torch_cluster.py``).

A :class:`~repro_torch.core.delay_model.DelayTrace` records *realized staleness*
``tau_k`` per commit — an exogenous host-side artifact.  A
:class:`WorkerSchedule` re-expresses the same simulated execution as the
thing the paper's P workers actually do: commit ``k`` was produced by worker
``worker_ids[k]`` which *read* the shared iterate at server version
``read_versions[k] = k - tau_k`` and committed at wall-clock
``commit_times[k]``.

The executor derives staleness *endogenously* as ``version_now -
read_version`` from the carried commit counter, so delays are a
consequence of the schedule rather than a side-channel input.  Because
``version_now == k`` in trace order, the derived staleness reproduces
``trace.delays`` exactly — which is what keeps chain c of the ensemble
bitwise equal to the single-chain :class:`~repro_torch.train.engine.Engine`.

``stack_schedules`` batches C independent per-chain schedules into the
``(steps, C)`` arrays the ensemble walks; ``ensemble_async`` builds them
straight from a :class:`~repro_torch.core.delay_model.WorkerModel`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.delay import StalenessError  # noqa: F401  (re-exported)
from repro_torch.core.delay import check_staleness_fits
from repro_torch.core.delay_model import DelayTrace, WorkerModel, simulate_async
from repro_torch.utils import bucket_size


@dataclass(frozen=True)
class WorkerSchedule:
    """One chain's compiled commit schedule (trace order = commit order).

    ``batch_sizes`` (optional) is the bucketed per-commit minibatch size —
    how much data the committing worker averaged its delayed gradient over.
    The compiled form also carries :attr:`data_offsets`: commit ``k``
    consumes rows ``[offset_k, offset_k + batch_sizes[k])`` of the chain's
    data stream, so the executor's padded windowed gather needs no host
    bookkeeping.

    ``alive`` (optional) is the per-commit liveness mask from a chaos
    schedule (see :class:`~repro_torch.core.delay_model.FaultPlan`): ``False``
    commits are crashed workers' lost updates, which the executor executes
    as masked no-ops.  ``None`` — the fault-free contract — keeps every
    downstream code path bitwise identical to pre-fault behavior.
    """

    read_versions: np.ndarray  # (num_commits,) int32: server version each read saw
    worker_ids: np.ndarray     # (num_commits,) int32: which worker committed
    commit_times: np.ndarray   # (num_commits,) float64: simulated wall clock
    num_workers: int
    batch_sizes: np.ndarray | None = None  # (num_commits,) int32 per commit
    alive: np.ndarray | None = None        # (num_commits,) bool, False = lost

    def __post_init__(self):
        k = np.arange(len(self.read_versions))
        if np.any(self.read_versions < 0) or np.any(self.read_versions > k):
            raise ValueError("read_versions must satisfy 0 <= v_read[k] <= k")
        if self.batch_sizes is not None:
            sizes = np.asarray(self.batch_sizes, np.int32)
            if sizes.shape != self.read_versions.shape:
                raise ValueError(
                    f"batch_sizes shape {sizes.shape} must match "
                    f"read_versions shape {self.read_versions.shape}")
            if np.any(sizes < 1):
                raise ValueError("batch_sizes must be >= 1 per commit")
            object.__setattr__(self, "batch_sizes", sizes)
        if self.alive is not None:
            live = np.asarray(self.alive, bool)
            if live.shape != self.read_versions.shape:
                raise ValueError(
                    f"alive shape {live.shape} must match read_versions "
                    f"shape {self.read_versions.shape}")
            object.__setattr__(self, "alive", live)

    def __len__(self) -> int:
        return int(self.read_versions.shape[0])

    @property
    def delays(self) -> np.ndarray:
        """Realized staleness tau_k = k - read_version[k] (host view)."""
        return (np.arange(len(self), dtype=np.int64)
                - self.read_versions).astype(np.int32)

    @property
    def max_delay(self) -> int:
        """Largest realized staleness in the schedule (0 when empty) — the
        floor on the ring depth any executor needs to replay it."""
        return int(self.delays.max(initial=0))

    @property
    def data_offsets(self) -> np.ndarray | None:
        """Per-commit start row in the chain's data stream: the exclusive
        cumulative sum of ``batch_sizes`` (``None`` without sizes)."""
        if self.batch_sizes is None:
            return None
        offs = np.zeros(len(self), np.int64)
        np.cumsum(self.batch_sizes[:-1], out=offs[1:])
        return offs

    @property
    def worker_slots(self) -> np.ndarray:
        """Worker-local commit index: commit ``k`` is the ``slots[k]``-th
        commit of worker ``worker_ids[k]``.  The pair ``(worker_id, slot)``
        identifies a commit independently of global commit order — the key
        the per-worker RNG attribution folds into the noise stream."""
        slots = np.zeros(len(self), np.int32)
        counts: dict[int, int] = {}
        for k, w in enumerate(np.asarray(self.worker_ids)):
            slots[k] = counts.get(int(w), 0)
            counts[int(w)] = slots[k] + 1
        return slots

    @property
    def num_lost(self) -> int:
        """Commits lost to crashes (0 for a fault-free schedule)."""
        return 0 if self.alive is None else int((~self.alive).sum())

    @property
    def grad_evals(self) -> np.ndarray:
        """Cumulative gradient evaluations after each commit (inclusive) —
        the equal-compute axis for comparing batch policies."""
        if self.batch_sizes is None:
            return np.arange(1, len(self) + 1, dtype=np.int64)
        return np.cumsum(self.batch_sizes.astype(np.int64))

    @classmethod
    def from_trace(cls, trace: DelayTrace) -> "WorkerSchedule":
        """Build a schedule from a simulator :class:`DelayTrace`, turning
        its per-commit delays back into absolute read versions."""
        k = np.arange(len(trace.delays), dtype=np.int64)
        return cls(read_versions=(k - trace.delays).astype(np.int32),
                   worker_ids=np.asarray(trace.worker_ids, np.int32),
                   commit_times=np.asarray(trace.commit_times, np.float64),
                   num_workers=trace.num_workers,
                   batch_sizes=trace.batch_sizes,
                   alive=trace.alive)

    @classmethod
    def from_delays(cls, delays: np.ndarray,
                    commit_times: np.ndarray | None = None) -> "WorkerSchedule":
        """Single-worker schedule realizing the given per-commit delays;
        commit times default to unit spacing when not supplied."""
        delays = np.asarray(delays, np.int64)
        k = np.arange(len(delays), dtype=np.int64)
        times = (np.arange(1, len(delays) + 1, dtype=np.float64)
                 if commit_times is None else np.asarray(commit_times, np.float64))
        return cls(read_versions=(k - delays).astype(np.int32),
                   worker_ids=np.zeros(len(delays), np.int32),
                   commit_times=times, num_workers=1)

    @classmethod
    def sync(cls, num_commits: int) -> "WorkerSchedule":
        """Barrier baseline: every read is fresh (tau = 0)."""
        return cls.from_delays(np.zeros(num_commits, np.int32))

    def validate_ring(self, depth: int, context: str = "") -> None:
        """Raise unless every read the schedule demands fits in the ring."""
        check_staleness_fits(self.max_delay, depth, context or "schedule")

    def to_trace(self) -> DelayTrace:
        """Inverse of :meth:`from_trace`: export the schedule as a
        :class:`DelayTrace` for the simulator/diagnostics tooling."""
        return DelayTrace(delays=self.delays, commit_times=self.commit_times,
                          worker_ids=self.worker_ids,
                          num_workers=self.num_workers,
                          batch_sizes=self.batch_sizes,
                          alive=self.alive)

    def with_batch_sizes(self, batch_sizes: np.ndarray,
                         buckets: Sequence[int] | None = None
                         ) -> "WorkerSchedule":
        """The same schedule with explicit per-commit batch sizes, snapped up
        the bucket ladder (powers of two, or an explicit ``buckets``
        contract) so the executor compiles one trace per rung."""
        sizes = np.asarray(batch_sizes, np.int64)
        if sizes.ndim == 0:
            sizes = np.full(len(self), int(sizes))
        snapped = np.array([bucket_size(int(b), buckets) for b in sizes],
                           np.int32)
        return WorkerSchedule(
            read_versions=self.read_versions, worker_ids=self.worker_ids,
            commit_times=self.commit_times, num_workers=self.num_workers,
            batch_sizes=snapped, alive=self.alive)


def stack_schedules(schedules: Sequence[WorkerSchedule],
                    steps: int | None = None):
    """Batch C per-chain schedules into ``(steps, C)`` arrays.

    Returns ``(read_versions, commit_times)`` with the step axis leading, the
    layout the executor consumes directly.  With ``steps``
    each schedule is trimmed to its first ``steps`` commits (every schedule
    must cover that many); without it the schedules must share one length.
    """
    if steps is None:
        lengths = {len(s) for s in schedules}
        if len(lengths) != 1:
            raise ValueError("chains must share a commit count, got lengths "
                             f"{sorted(lengths)} (or pass steps= to trim)")
        steps = lengths.pop()
    short = min(len(s) for s in schedules)
    if short < steps:
        raise ValueError(f"schedule covers {short} commits, need {steps}")
    rv = np.stack([s.read_versions[:steps] for s in schedules], axis=1)
    times = np.stack([s.commit_times[:steps] for s in schedules], axis=1)
    return rv.astype(np.int32), times


def stack_batch_info(schedules: Sequence[WorkerSchedule], steps: int):
    """Batch the per-chain minibatch plans into ``(steps, C)`` arrays.

    Returns ``(batch_sizes int32, data_offsets int64)`` with the step axis
    leading, or ``None`` when no schedule carries sizes; a mix of sized and
    size-less schedules is a contract violation and raises.
    """
    have = [s.batch_sizes is not None for s in schedules]
    if not any(have):
        return None
    if not all(have):
        raise ValueError("either every chain's schedule carries batch_sizes "
                         "or none does — got a mix")
    sizes = np.stack([s.batch_sizes[:steps] for s in schedules], axis=1)
    offs = np.stack([s.data_offsets[:steps] for s in schedules], axis=1)
    return sizes.astype(np.int32), offs.astype(np.int64)


def stack_worker_info(schedules: Sequence[WorkerSchedule], steps: int):
    """Batch per-chain worker attribution into ``(steps, C)`` int32 arrays:
    ``(worker_ids, worker_slots)`` — the inputs the executor folds into
    per-commit noise keys under ``worker_rng=True``."""
    wid = np.stack([s.worker_ids[:steps] for s in schedules], axis=1)
    slot = np.stack([s.worker_slots[:steps] for s in schedules], axis=1)
    return wid.astype(np.int32), slot.astype(np.int32)


def stack_liveness(schedules: Sequence[WorkerSchedule],
                   steps: int) -> np.ndarray | None:
    """Batch per-chain liveness into a ``(steps, C)`` bool mask.

    Chains without an ``alive`` mask broadcast to all-True (their commits
    all landed).  Returns ``None`` when no commit in the window was lost —
    including the case where every schedule is fault-free — so the executor
    only threads a liveness input (and only changes its compiled program)
    when a fault actually realized.
    """
    if all(s.alive is None for s in schedules):
        return None
    live = np.stack(
        [np.ones(steps, bool) if s.alive is None else s.alive[:steps]
         for s in schedules], axis=1)
    return None if live.all() else live


def ensemble_async(model: WorkerModel, num_commits: int, num_chains: int,
                   seed: int = 0, *, batch_policy: str = "fixed",
                   base_batch: int = 1, buckets=None) -> list[WorkerSchedule]:
    """C independent async executions of the same worker pool (chain c gets
    its own event-driven simulation seeded ``seed + c``).  ``batch_policy``
    / ``base_batch`` / ``buckets`` couple per-commit batch sizes to the
    drawn compute times (see :func:`~repro_torch.core.delay_model.simulate_async`).
    """
    return [WorkerSchedule.from_trace(
                simulate_async(model, num_commits, seed=seed + c,
                               batch_policy=batch_policy,
                               base_batch=base_batch, buckets=buckets))
            for c in range(num_chains)]
