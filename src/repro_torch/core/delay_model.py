"""Event-driven virtual-worker simulator: realistic, *seeded* delay processes.

The paper's delays come from OS/NUMA/MPS scheduling races (it had to average
three runs per figure).  We replace the physical race with an event-driven
simulation of ``P`` workers, each drawing per-step compute times from a
heterogeneous distribution.  A worker reads the model at commit-version
``v_read``, computes for a sampled duration, then commits; its realized
staleness is ``tau_k = v_now - v_read`` — exactly the paper's consistent-read
model.  The simulator also yields commit wall-clock times, which drive the
speedup figures (paper Figs 1b/2b/3b) without real hardware.

Pure numpy on the host; outputs are fed to the sampler as arrays.  A copy
of ``repro.core.delay_model`` (the port imports nothing of ``repro``),
pinned bitwise to it by ``tests/test_torch_sgld.py``.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from repro_torch.utils import bucket_size

#: the batch-size policy vocabulary (shared with
#: :class:`repro.cluster.ClusterEngine`).  :meth:`WorkerModel.batch_sizes`
#: draws ``"fixed"`` and ``"inverse-speed"``; ``"explicit"`` sizes bypass
#: the worker model and are passed straight to the executor.
BATCH_POLICIES = ("fixed", "inverse-speed", "explicit")

#: salt folded into the fault RNG seed so the chaos draws come from a stream
#: *disjoint* from the step-time draws — a :class:`FaultPlan` with zero rates
#: leaves the realized zero-fault trace bitwise identical.
_FAULT_SEED_SALT = 0xFA17

# event states on the simulator heap (4-tuple entries under a FaultPlan)
_EV_RUN = 0      # worker computing normally
_EV_STALLED = 1  # worker paused mid-step (stall already drawn; commits next)
_EV_REJOIN = 2   # worker coming back from a crash; re-reads fresh params


@dataclass(frozen=True)
class FaultPlan:
    """Per-commit fault process for :func:`simulate_async` chaos schedules.

    All draws come from a dedicated RNG stream (seeded with
    ``(seed, _FAULT_SEED_SALT)``), so attaching a plan with zero rates —
    or no plan at all — reproduces today's traces bitwise.

    - ``crash_rate``: probability a commit is lost mid-write.  The slot is
      still burned (version counter advances, preserving the all-commit
      numbering the executor's endogenous-staleness contract relies on) but
      the update is marked dead in :attr:`DelayTrace.alive`; the worker goes
      down for an exponential ``mean_downtime`` (in units of
      ``mean_step_time``) and *re-reads fresh params* when it rejoins.
    - ``pause_rate``: probability a worker is preempted just before its
      commit, stalling an exponential ``mean_pause`` before the (now even
      staler) gradient lands.  The commit itself survives.
    """

    crash_rate: float = 0.0
    mean_downtime: float = 2.0
    pause_rate: float = 0.0
    mean_pause: float = 1.0

    def __post_init__(self):
        for name in ("crash_rate", "pause_rate"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"FaultPlan.{name} must be in [0, 1), got {v}")
        for name in ("mean_downtime", "mean_pause"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"FaultPlan.{name} must be >= 0")

    @property
    def active(self) -> bool:
        """Whether this plan can realize any fault at all."""
        return self.crash_rate > 0.0 or self.pause_rate > 0.0


@dataclass
class DelayTrace:
    """Realized asynchronous schedule.

    ``batch_sizes`` (optional) is the per-commit minibatch size the committing
    worker averaged its gradient over — ``None`` means the legacy fixed-shape
    contract where every commit consumes one engine-defined minibatch.

    ``alive`` (optional) marks commits that actually landed: ``False`` slots
    are crashed workers' in-flight commits, which the executor turns into
    masked no-ops.  ``None`` means every commit landed (the zero-fault
    contract — note ``None``, not an all-True array, so fault-free plumbing
    stays bitwise identical to a trace that never saw a :class:`FaultPlan`).
    """

    delays: np.ndarray        # (num_commits,) int32 staleness tau_k per commit
    commit_times: np.ndarray  # (num_commits,) float64 simulated wall clock
    worker_ids: np.ndarray    # (num_commits,) which worker committed
    num_workers: int
    batch_sizes: np.ndarray | None = None  # (num_commits,) int32 per commit
    alive: np.ndarray | None = None        # (num_commits,) bool, False = lost

    @property
    def max_delay(self) -> int:
        return int(self.delays.max(initial=0))

    @property
    def num_lost(self) -> int:
        """Commits lost to crashes (0 for a fault-free trace)."""
        return 0 if self.alive is None else int((~self.alive).sum())

    @property
    def mean_delay(self) -> float:
        return float(self.delays.mean()) if self.delays.size else 0.0

    @property
    def total_grad_evals(self) -> int:
        """Total gradient evaluations = sum of per-commit batch sizes (one
        per commit under the legacy fixed-shape contract)."""
        if self.batch_sizes is None:
            return int(self.delays.shape[0])
        return int(self.batch_sizes.sum())


@dataclass
class WorkerModel:
    """Per-step compute-time distribution for the virtual workers.

    ``heterogeneity`` scales a fixed per-worker speed multiplier (NUMA socket
    imbalance); ``cv`` is the per-step lognormal coefficient of variation
    (OS jitter).
    """

    num_workers: int
    mean_step_time: float = 1.0
    cv: float = 0.3
    heterogeneity: float = 0.2
    update_cost: float = 0.05  # serialized commit (lock / memory write) time
    seed: int = 0
    faults: FaultPlan | None = None  # chaos process; None = fault-free
    _speeds: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._speeds = 1.0 + self.heterogeneity * rng.uniform(-1, 1, self.num_workers)

    def sample_step_time(self, rng: np.random.Generator, worker: int) -> float:
        mu = self.mean_step_time * self._speeds[worker]
        sigma = np.sqrt(np.log1p(self.cv**2))
        return float(mu * rng.lognormal(-0.5 * sigma**2, sigma))

    def batch_sizes(self, batch_policy: str = "fixed", *, base_batch: int = 1,
                    buckets=None) -> np.ndarray:
        """Per-worker minibatch size under ``batch_policy``.

        - ``fixed``: every worker consumes exactly ``base_batch`` per commit
          (the legacy contract — sizes are *not* bucket-snapped, so the
          realized schedule is unchanged).
        - ``inverse-speed``: a worker's batch scales with its per-step time
          relative to the fastest worker (Chen et al.'s staleness/variance
          trade: slow workers amortize their inevitable staleness over more
          data, fast workers commit fresh low-latency gradients), snapped up
          the bucket ladder so mixed sizes compile one trace per rung.
        """
        if batch_policy == "fixed":
            return np.full(self.num_workers, base_batch, np.int32)
        if batch_policy == "inverse-speed":
            rel = self._speeds / self._speeds.min()  # slowest -> largest
            raw = np.maximum(1, np.round(base_batch * rel)).astype(np.int64)
            return np.array([bucket_size(int(b), buckets) for b in raw],
                            np.int32)
        raise ValueError(
            f"unknown batch policy {batch_policy!r} for a WorkerModel "
            f"(choose from {BATCH_POLICIES[:2]}; 'explicit' sizes are passed "
            "straight to the executor)")


def simulate_async(model: WorkerModel, num_commits: int, seed: int = 0, *,
                   batch_policy: str = "fixed", base_batch: int = 1,
                   buckets=None) -> DelayTrace:
    """Asynchronous execution: every worker free-runs; commits serialize.

    ``batch_policy`` couples each worker's per-commit batch size to its
    drawn compute times: a commit over ``b`` examples takes ``b/base_batch``
    times the worker's sampled per-``base_batch`` step time, so larger
    batches make a worker commit less often but average more data — the
    realized staleness *and* the realized batch sizes come out of one
    event-driven simulation.  With the default fixed policy the time scale
    factor is exactly 1.0 and the realized trace is unchanged.
    """
    sizes = model.batch_sizes(batch_policy, base_batch=base_batch,
                              buckets=buckets)
    scale = sizes.astype(np.float64) / float(base_batch)
    rng = np.random.default_rng(seed)
    if model.faults is not None and model.faults.active:
        return _simulate_chaos(model, num_commits, seed, rng, sizes, scale)
    heap: list[tuple[float, int, int]] = []  # (finish_time, worker, read_version)
    for w in range(model.num_workers):
        heapq.heappush(heap, (model.sample_step_time(rng, w) * scale[w], w, 0))

    delays = np.empty(num_commits, dtype=np.int32)
    times = np.empty(num_commits, dtype=np.float64)
    workers = np.empty(num_commits, dtype=np.int32)
    version = 0
    for k in range(num_commits):
        t, w, v_read = heapq.heappop(heap)
        t += model.update_cost  # serialized write
        delays[k] = version - v_read
        times[k] = t
        workers[k] = w
        version += 1
        heapq.heappush(heap,
                       (t + model.sample_step_time(rng, w) * scale[w], w,
                        version))
    return DelayTrace(delays=delays, commit_times=times, worker_ids=workers,
                      num_workers=model.num_workers,
                      batch_sizes=sizes[workers])


def _simulate_chaos(model: WorkerModel, num_commits: int, seed: int,
                    rng: np.random.Generator, sizes: np.ndarray,
                    scale: np.ndarray) -> DelayTrace:
    """The fault-injected event loop behind :func:`simulate_async`.

    Same event-driven core, plus crash/pause/rejoin events drawn from a
    *separate* RNG stream.  A crashed commit still burns a version slot (so
    ``read_versions`` keep the all-commit numbering the executor derives
    staleness against) but is marked dead in ``alive``; the crashed worker
    rejoins after an exponential downtime and re-reads the then-current
    version — exactly the elastic join/leave semantics the ROADMAP asks for.
    """
    plan = model.faults
    rng_f = np.random.default_rng((seed, _FAULT_SEED_SALT))
    # (finish_time, worker, read_version, event_state)
    heap: list[tuple[float, int, int, int]] = []
    for w in range(model.num_workers):
        heapq.heappush(heap,
                       (model.sample_step_time(rng, w) * scale[w], w, 0,
                        _EV_RUN))

    delays = np.empty(num_commits, dtype=np.int32)
    times = np.empty(num_commits, dtype=np.float64)
    workers = np.empty(num_commits, dtype=np.int32)
    alive = np.ones(num_commits, dtype=bool)
    version = 0
    k = 0
    while k < num_commits:
        t, w, v_read, ev = heapq.heappop(heap)
        if ev == _EV_REJOIN:
            # back from the dead: fresh read of the current version
            heapq.heappush(heap,
                           (t + model.sample_step_time(rng, w) * scale[w], w,
                            version, _EV_RUN))
            continue
        if ev == _EV_RUN and rng_f.random() < plan.pause_rate:
            # preempted just before the commit; the gradient only gets staler
            stall = rng_f.exponential(plan.mean_pause * model.mean_step_time)
            heapq.heappush(heap, (t + stall, w, v_read, _EV_STALLED))
            continue
        crashed = rng_f.random() < plan.crash_rate
        t += model.update_cost  # serialized write (attempted either way)
        delays[k] = version - v_read
        times[k] = t
        workers[k] = w
        alive[k] = not crashed
        version += 1
        k += 1
        if crashed:
            down = rng_f.exponential(plan.mean_downtime * model.mean_step_time)
            heapq.heappush(heap, (t + down, w, -1, _EV_REJOIN))
        else:
            heapq.heappush(heap,
                           (t + model.sample_step_time(rng, w) * scale[w], w,
                            version, _EV_RUN))
    return DelayTrace(delays=delays, commit_times=times, worker_ids=workers,
                      num_workers=model.num_workers,
                      batch_sizes=sizes[workers], alive=alive)


def simulate_sync(model: WorkerModel, num_rounds: int, seed: int = 0) -> DelayTrace:
    """Synchronous (barrier) execution: one summed update per round.

    Round time = max over workers' draws (barrier) + one serialized update.
    Delay is 0 by construction.
    """
    rng = np.random.default_rng(seed)
    times = np.empty(num_rounds, dtype=np.float64)
    t = 0.0
    for k in range(num_rounds):
        t += max(model.sample_step_time(rng, w) for w in range(model.num_workers))
        t += model.update_cost
        times[k] = t
    return DelayTrace(
        delays=np.zeros(num_rounds, dtype=np.int32),
        commit_times=times,
        worker_ids=np.zeros(num_rounds, dtype=np.int32),
        num_workers=model.num_workers,
    )


def constant_delays(tau: int, num_commits: int) -> DelayTrace:
    """Worst-case fixed staleness (theory experiments)."""
    d = np.full(num_commits, tau, dtype=np.int32)
    d[: tau + 1] = np.arange(min(tau + 1, num_commits))  # warm-up: can't be staler than k
    return DelayTrace(
        delays=d,
        commit_times=np.arange(1, num_commits + 1, dtype=np.float64),
        worker_ids=np.zeros(num_commits, dtype=np.int32),
        num_workers=1,
    )


def truncate_to_evals(trace: DelayTrace, evals: int) -> DelayTrace:
    """Clip a trace at a gradient-evaluation budget: keep the shortest commit
    prefix whose summed batch sizes reach ``evals`` (commit count, for a
    legacy trace without sizes).  The equal-compute axis for comparing batch
    policies: heterogeneous and fixed schedules truncated to one budget have
    consumed the same number of per-example gradients."""
    sizes = (np.ones(len(trace.delays), np.int64) if trace.batch_sizes is None
             else trace.batch_sizes.astype(np.int64))
    total = np.cumsum(sizes)
    if total.size == 0 or total[-1] < evals:
        raise ValueError(f"trace holds {int(total[-1]) if total.size else 0} "
                         f"grad evals, need {evals} — simulate more commits")
    k = int(np.searchsorted(total, evals)) + 1
    return DelayTrace(
        delays=trace.delays[:k], commit_times=trace.commit_times[:k],
        worker_ids=trace.worker_ids[:k], num_workers=trace.num_workers,
        batch_sizes=None if trace.batch_sizes is None
        else trace.batch_sizes[:k],
        alive=None if trace.alive is None else trace.alive[:k])


def speedup_vs_sync(async_trace: DelayTrace, sync_trace: DelayTrace) -> float:
    """Wall-clock speedup at equal gradient-evaluation counts.

    Sync evaluates P gradients per round; async evaluates 1 per commit.
    Compare time to consume the same number of gradient evaluations.
    """
    p = async_trace.num_workers
    n_async = len(async_trace.commit_times)
    n_rounds = max(1, n_async // p)
    if len(sync_trace.commit_times) < n_rounds:
        raise ValueError("sync trace too short")
    return float(sync_trace.commit_times[n_rounds - 1] / async_trace.commit_times[n_async - 1])
