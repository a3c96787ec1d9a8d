"""ClusterEngine: the multi-chain async-SGLD executor on one card (port of
``repro.cluster.executor``).

The same contract as :class:`repro_torch.train.engine.Engine` — chunks,
hooks between them, a trace counter — over a C-chain
:func:`~repro_torch.cluster.ensemble.init_ensemble` state: each commit
advances every chain through the transform chain's update
(:func:`~repro_torch.cluster.ensemble.step_chains`), the read and the
fused commit one kernel launch a leaf for every chain, the gradient one
oracle call a chain.

Delays are *endogenous*: the executor walks the schedule's per-chain
``read_versions`` and derives each commit's staleness as ``version -
read_version`` from the carried commit counter, so the worker schedule is
executed, not read as a side channel.

Batch sizes are part of the schedule: under ``batch_policy="inverse-speed"``
(or ``"explicit"``) every commit carries its own minibatch size and data
offset, and the executor gathers a *bucket-padded* window from the
``data`` stream (wrapping modulo its length): each chunk pads to the
ladder rung of its largest commit, and the
:class:`~repro_torch.samplers.transforms.MaskedBatch` mask keeps the padding
rows out of the gradient average.  ``batch_policy="fixed"`` (the default)
hands each commit one fixed-shape batch.

Left for later slices (each refused with a ``ValueError`` that says where
it is queued in ROADMAP.md): the fault knobs — ``health_check=True``,
``poison=``, schedules that lose commits (ROADMAP Queue 1 item 5) — and the
checkpoints — ``checkpoint_path=``, :meth:`ClusterEngine.resume`,
:meth:`ClusterEngine.save_ensemble` (items 4-5); and ``mesh=`` (chains
sharded over several cards), which one card cannot test.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.ensemble import init_ensemble, step_chains
from repro_torch.cluster.schedule import (
    WorkerSchedule,
    stack_batch_info,
    stack_liveness,
    stack_schedules,
    stack_worker_info,
)
from repro_torch.core.delay import validate_staleness
from repro_torch.core.delay_model import BATCH_POLICIES
from repro_torch.obs.metrics import STALENESS_BUCKETS, registry as _registry
from repro_torch.samplers.base import Sampler, SamplerState
from repro_torch.samplers.transform import chain_at
from repro_torch.samplers.transforms import MaskedBatch
from repro_torch.train.engine import Hook, _to_host, drive_chunks
from repro_torch.utils import bucket_size, to_device, tree_leaves, tree_map

PyTree = Any
BatchFn = Callable[[torch.Generator], PyTree]  # generator -> one chain's batch
ScheduleLike = Any  # WorkerSchedule | Sequence[WorkerSchedule] | np.ndarray | None

_FAULTS = "ROADMAP Queue 1 item 5 (faults and self-healing)"
_CHECKPOINTS = "ROADMAP Queue 1 items 4-5 (checkpoints, then resume)"


def _later(knob: str, where: str) -> ValueError:
    return ValueError(f"ClusterEngine: {knob} is not ported yet; it comes "
                      f"with {where}")


@dataclass
class ClusterEngine:
    """Chunked executor for a C-chain async-SGLD ensemble.

    ``batch_fn(generator) -> batch`` (optional) draws an independent
    minibatch per (commit, chain) from one ``torch.Generator`` seeded by
    ``run``'s ``key``; explicit ``batches`` passed to :meth:`run` go to
    every chain unless ``per_chain_batches=True`` (then their second axis
    is the chain axis); with neither, every commit gets a ``(1,)`` zero
    tensor (batchless oracles, as the JAX engine).

    ``batch_policy``: ``"fixed"`` (one batch a commit), ``"inverse-speed"``
    (per-commit sizes from the schedules' ``batch_sizes``) or
    ``"explicit"`` (sizes passed to :meth:`run`, snapped up the
    ``buckets`` ladder); the last two consume masked windows of the
    ``data=`` stream and need the per-example oracle contract
    (``samplers.sgld(..., base_batch=...)``).

    ``worker_rng`` derives each commit's keys from ``(chain key, worker_id,
    worker-local slot)`` (:func:`~repro_torch.cluster.ensemble.worker_keys`)
    instead of splitting the carried key.
    """

    sampler: Sampler
    num_chains: int
    chunk_size: int = 50
    hooks: Sequence[Hook] = ()
    collect_aux: bool = False
    batch_fn: Optional[BatchFn] = None
    per_chain_batches: bool = False
    batch_policy: str = "fixed"
    buckets: Optional[Sequence[int]] = None
    worker_rng: bool = False
    health_check: bool = False
    mesh: Any = None
    _layouts: set = field(default_factory=set, init=False, repr=False)

    def __post_init__(self):
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.num_chains < 1:
            raise ValueError(f"num_chains must be >= 1, got {self.num_chains}")
        if self.batch_policy not in BATCH_POLICIES:
            raise ValueError(f"unknown batch_policy {self.batch_policy!r} "
                             f"(choose from {BATCH_POLICIES})")
        if self.batch_policy != "fixed" and self.batch_fn is not None:
            raise ValueError(
                "batch_fn generates fixed-shape minibatches; heterogeneous "
                "batch policies consume a `data=` stream passed to run()")
        if self.health_check:
            raise _later("health_check=True", _FAULTS)
        if self.mesh is not None:
            raise ValueError("ClusterEngine: mesh= (chains sharded over several "
                             "cards) is left out of the port: one card cannot "
                             "test it (ROADMAP Queue 1 items 2 and 9)")
        reg = _registry()
        self._m_staleness = reg.histogram(
            "cluster.staleness", STALENESS_BUCKETS,
            "per-commit staleness tau = version - read_version")
        self._m_commits = reg.counter("cluster.commits",
                                      "commits executed (steps x chains)")
        self._m_grad_evals = reg.counter(
            "cluster.grad_evals",
            "per-example gradient evaluations (non-fixed batch policies)")
        self._m_max_stale = reg.gauge("cluster.max_staleness",
                                      "largest tau in the newest schedule")

    @property
    def num_traces(self) -> int:
        """Distinct chunk layouts run so far — (batch layout, chunk length),
        and for masked windows (ladder rung, chunk length) — what the JAX
        engine counts as jit traces."""
        return len(self._layouts)

    # -- init / export ----------------------------------------------------------
    def init(self, params: PyTree, key, *, jitter: float = 0.0) -> SamplerState:
        """C-chain ensemble state; chain ``c``'s key is ``split(key, C)[c]``."""
        return init_ensemble(self.sampler, params, key,
                             num_chains=self.num_chains, jitter=jitter)

    def save_ensemble(self, state: SamplerState, path: str) -> None:
        raise _later("save_ensemble", "ROADMAP Queue 1 item 4 (checkpoints)")

    def resume(self, checkpoint_path: str, state: SamplerState, **kw):
        raise _later("resume", _CHECKPOINTS)

    # -- schedule normalisation ---------------------------------------------------
    def _compile_schedule(self, schedule: ScheduleLike, steps: int):
        """-> (extra dict of (steps, C) arrays, commit_times | None,
        batch_info (sizes, offsets) | None); ``extra`` holds ``rv`` (read
        versions) and, under ``worker_rng``, ``wid`` / ``slot``."""
        c = self.num_chains
        raw_delays = isinstance(schedule, (np.ndarray, torch.Tensor))
        if schedule is None:
            scheds = [WorkerSchedule.sync(steps)] * c
        elif raw_delays:
            arr = np.asarray(schedule)
            if arr.ndim == 1:
                scheds = [WorkerSchedule.from_delays(arr)] * c
            elif arr.ndim == 2:
                scheds = [WorkerSchedule.from_delays(arr[:, i])
                          for i in range(arr.shape[1])]
            else:
                raise ValueError("delay array must be (steps,) or (steps, C)")
        else:
            scheds = ([schedule] * c if isinstance(schedule, WorkerSchedule)
                      else list(schedule))
        if len(scheds) != c:
            raise ValueError(f"got {len(scheds)} per-chain schedules for {c} chains")
        rv, times = stack_schedules(scheds, steps=steps)
        extra = {"rv": rv}
        if self.worker_rng:
            extra["wid"], extra["slot"] = stack_worker_info(scheds, steps)
        if stack_liveness(scheds, steps) is not None:
            raise _later("a schedule that loses commits (alive masks)", _FAULTS)
        times = None if (schedule is None or raw_delays) else times
        return extra, times, stack_batch_info(scheds, steps)

    def _compile_batch_plan(self, batch_info, batch_sizes, steps: int):
        """-> ((steps, C) int32 sizes, (steps, C) int64 offsets) for the
        masked path, honouring the batch policy."""
        if self.batch_policy == "explicit":
            if batch_sizes is None:
                raise ValueError('batch_policy="explicit" needs batch_sizes= '
                                 "((steps,) or (steps, C)) passed to run()")
            sizes = np.asarray(batch_sizes, np.int64)
            if sizes.ndim == 0:
                sizes = np.full((steps,), int(sizes), np.int64)
            if sizes.ndim == 1:
                sizes = np.tile(sizes[:, None], (1, self.num_chains))
            if sizes.shape[0] < steps:
                raise ValueError(f"batch_sizes has {sizes.shape[0]} entries, "
                                 f"need {steps}")
            snap = np.vectorize(lambda b: bucket_size(int(b), self.buckets))
            sizes = snap(sizes[:steps]).astype(np.int32)
            offs = np.zeros_like(sizes, dtype=np.int64)
            np.cumsum(sizes[:-1].astype(np.int64), axis=0, out=offs[1:])
            return sizes, offs
        if batch_info is None:
            raise ValueError(
                'batch_policy="inverse-speed" needs schedules carrying '
                'batch_sizes (ensemble_async(..., batch_policy="inverse-speed") '
                "or WorkerSchedule.with_batch_sizes)")
        return batch_info

    # -- one chunk -------------------------------------------------------------------
    def _run_chunk(self, state: SamplerState, batches: list, extra: dict):
        """``batches``: one list of C batches a commit of the chunk."""
        auxs = []
        for j, chain_batches in enumerate(batches):
            delays = state.step - extra["rv"][j].astype(np.int64)  # endogenous
            if self.worker_rng:
                state, aux = step_chains(self.sampler, state, chain_batches, delays,
                                         extra["wid"][j], extra["slot"][j])
            else:
                state, aux = step_chains(self.sampler, state, chain_batches, delays)
            if self.collect_aux:
                auxs.append(aux)
        return state, _to_host(auxs)

    # -- host driver -----------------------------------------------------------------
    def run(self, state: SamplerState, *, steps: int, schedule: ScheduleLike = None,
            batches: Optional[PyTree] = None, key=None,
            data: Optional[PyTree] = None, batch_sizes=None, poison=None,
            checkpoint_path: Optional[str] = None, checkpoint_every=None):
        """Advance every chain ``steps`` commits under ``schedule``: one
        :class:`~repro_torch.cluster.schedule.WorkerSchedule` (every
        chain), C per-chain schedules, a raw delay array (``(steps,)`` or
        ``(steps, C)``), or ``None`` (synchronous).  Returns ``(state,
        aux)``, aux stacked ``(steps, C, ...)`` when ``collect_aux``; hooks
        see ``commit_time`` (and under a non-fixed policy ``grad_evals``)
        in their aux.  The state's tensors are updated in place.

        Under a non-fixed ``batch_policy``, ``data=`` is the example stream
        (a tree with a leading row axis): commit ``k`` of chain ``c``
        consumes rows ``[offset, offset + size)``, wrapping modulo the
        stream and restarting at 0 on every call, as a bucket-padded
        :class:`~repro_torch.samplers.transforms.MaskedBatch`.  ``key``: a
        ``torch.Generator``, or an int seed of one, for ``batch_fn``.

        A run on an advanced state (a continuation) rebases the schedule's
        read versions (and, under ``worker_rng``, worker slots) onto the
        state's commit counter, so each commit's staleness is the
        schedule's tau_k.  ``poison`` and ``checkpoint_path`` are not
        ported yet and raise."""
        if poison is not None:
            raise _later("poison=", _FAULTS)
        if checkpoint_path is not None or checkpoint_every is not None:
            raise _later("checkpoint_path=", _CHECKPOINTS)
        extra, commit_times, batch_info = self._compile_schedule(schedule, steps)
        staleness = np.arange(steps, dtype=np.int64)[:, None] - extra["rv"]
        max_delay = int(staleness.max(initial=0))
        validate_staleness(max_delay, state.inner, context="schedule")
        self._m_staleness.observe_many(staleness.ravel())
        self._m_commits.inc(staleness.size)
        self._m_max_stale.set(float(max_delay))
        base = int(state.step)  # the chains commit in lockstep
        extra["rv"] = (extra["rv"] + base).astype(np.int64)
        if self.worker_rng:
            extra["slot"] = (extra["slot"] + base).astype(np.int64)

        pos = [0]  # the next chunk's first commit
        host_aux = None
        if self.batch_policy != "fixed":
            if data is None:
                raise ValueError(f"batch_policy={self.batch_policy!r} needs a "
                                 "data= example stream passed to run()")
            if batches is not None:
                raise ValueError("pass either data= (heterogeneous masked "
                                 "windows) or batches=, not both")
            sizes, offs = self._compile_batch_plan(batch_info, batch_sizes, steps)
            n_data = int(tree_leaves(data)[0].shape[0])
            offs = offs % n_data
            self._m_grad_evals.inc(int(sizes.sum()))
            host_aux = {"grad_evals": np.cumsum(sizes.astype(np.int64), axis=0)}
            device = tree_leaves(data)[0].device

            def gen(key, n):
                a = pos[0]
                pos[0] += n
                pad = bucket_size(int(sizes[a:a + n].max()), self.buckets)
                self._layouts.add(("masked", pad, n))
                out = []
                for k in range(a, a + n):
                    idx = torch.remainder(to_device(offs[k], device)[:, None]
                                          + torch.arange(pad, device=device), n_data)
                    rows = tree_map(lambda x: x[idx], data)  # (C, pad, ...)
                    out.append([MaskedBatch(chain_at(rows, c), int(sizes[k, c]))
                                for c in range(self.num_chains)])
                return key, out
        else:
            per_chain = self.per_chain_batches if batches is not None else \
                self.batch_fn is not None
            layout = "per_chain" if per_chain else "shared"
            if batches is not None:
                n_batches = tree_leaves(batches)[0].shape[0]
                if n_batches < steps:
                    raise ValueError(f"batches has {n_batches} entries, need {steps}")
            elif self.batch_fn is not None:
                if key is None:
                    raise ValueError("generating batches from batch_fn needs `key`")
                if not isinstance(key, torch.Generator):
                    key = torch.Generator().manual_seed(int(key))
            zero = torch.zeros(1)

            def gen(key, n):
                a = pos[0]
                pos[0] += n
                self._layouts.add((layout, n))
                out = []
                for k in range(a, a + n):
                    if batches is not None:
                        b = tree_map(lambda x: x[k], batches)
                        out.append([chain_at(b, c) for c in range(self.num_chains)]
                                   if per_chain else [b] * self.num_chains)
                    elif self.batch_fn is not None:
                        out.append([self.batch_fn(key) for _ in range(self.num_chains)])
                    else:
                        out.append([zero] * self.num_chains)
                return key, out

        return drive_chunks(
            self._run_chunk, state, steps=steps, chunk_size=self.chunk_size,
            hooks=self.hooks, collect_aux=self.collect_aux, extra=extra,
            gen_batches=gen, key=key, commit_times=commit_times,
            host_aux=host_aux)
