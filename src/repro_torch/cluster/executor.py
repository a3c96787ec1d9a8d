"""ClusterEngine: the multi-chain async-SGLD executor (port of
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

Faults, as in the JAX package: a chaos schedule's per-commit liveness mask
makes a crashed worker's commit a masked no-op; ``health_check=True``
carries a sticky per-chain health mask (:class:`HealthState`: a chain whose
iterate goes NaN/Inf is quarantined) with quarantined chains respawned
from healthy donors at chunk boundaries; and ``run(checkpoint_path=...)``
with :meth:`ClusterEngine.resume` restart a run bitwise.  Where the JAX
package selects between the old and the new state (``where(keep, new,
old)``), the port masks the commit itself, since the fused commit updates
the iterate in place: a masked chain's ring does not push and the kernel
skips its row, and a chain that goes non-finite in its commit is restored
from the ring slot its push just wrote (its pre-commit iterate).  Every
fault knob is opt-in: without them a commit launches what it launched
before and the host reads nothing back; ``health_check`` costs one ``(C,)``
read of the commit's non-finite flags a commit.

With ``mesh=`` (a ``torch.distributed.device_mesh.DeviceMesh``) the chains
are split in contiguous blocks over ``chain_axis`` (default ``"data"``) and
replicated over the other mesh axes, as ``P(chain_axis)`` splits them in the
JAX package: the state's tensors are ``DTensor`` leaves (``Shard(0)`` on the
chain axis), each rank builds and advances only its block — the chunk body
runs unchanged on the local rows (:func:`~repro_torch.utils.local`, the
counterpart of ``shard_map``), with the block's columns of the schedules —
and the per-chain host values (keys, ring heads) are the rank's own.  A
commit holds no cross-chain traffic, so a chain's trajectory is bitwise
the same placed or not.  Cross-chain traffic is where the JAX package has
it: the health mask gathered once a chunk under ``health_check``, a
respawn's donor rows, hooks that read the chain cloud, and checkpoints.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.instrument import counters as _counters
from repro_torch.cluster.ensemble import init_ensemble, worker_keys
from repro_torch.cluster.schedule import (
    WorkerSchedule,
    stack_batch_info,
    stack_liveness,
    stack_schedules,
    stack_worker_info,
)
from repro_torch.core.delay import RingBuffer, heads, validate_staleness
from repro_torch.core.delay_model import BATCH_POLICIES
from repro_torch.kernels import rng
from repro_torch.obs.metrics import STALENESS_BUCKETS, registry as _registry
from repro_torch.obs.trace import span as _span
from repro_torch.samplers.base import Sampler, SamplerState
from repro_torch.samplers.transform import chain_at, map_tensors
from repro_torch.samplers.transforms import MaskedBatch
from repro_torch.train.engine import Hook, _to_host, drive_chunks
from repro_torch.utils import (
    bucket_size,
    chain_block,
    gather_rows,
    is_placed,
    local,
    place_chains,
    to_device,
    tree_leaves,
    tree_map,
)

PyTree = Any
BatchFn = Callable[[tuple], PyTree]  # PRNG key -> one chain's batch
ScheduleLike = Any  # WorkerSchedule | Sequence[WorkerSchedule] | np.ndarray | None

#: fold_in tag minting a respawned chain's fresh noise stream from the
#: quarantined chain's (frozen) key: a deterministic function of the carry,
#: so a resumed run respawns as the uninterrupted one ("RES\x01")
_RESPAWN_TAG = 0x5245_5301


class HealthState(NamedTuple):
    """The carry under ``health_check``: the ensemble state plus the sticky
    per-chain health mask (``True`` = healthy; a chain's flips ``False``
    for good — until respawn — once its iterate goes NaN/Inf), a ``(C,)``
    host bool array.

    Delegating properties keep the :class:`~repro_torch.samplers.base.
    SamplerState` surface (``params`` / ``step`` / ``key`` / ``inner``), so
    hooks, recorders and ``save_ensemble`` take either carry."""

    state: SamplerState
    health: np.ndarray

    @property
    def params(self):
        """Chain-stacked iterate (delegates to the wrapped state)."""
        return self.state.params

    @property
    def step(self):
        """The commit counter (delegates to the wrapped state)."""
        return self.state.step

    @property
    def key(self):
        """Per-chain keys (delegates to the wrapped state)."""
        return self.state.key

    @property
    def inner(self):
        """Per-transform chain state (delegates to the wrapped state)."""
        return self.state.inner


def _float_leaves(params: PyTree) -> list:
    return [x for x in tree_leaves(params) if x.is_floating_point()]


def _finite_chains(params: PyTree) -> torch.Tensor:
    """(C,) bool on the parameters' device: which chains' iterates are
    all-finite (float leaves)."""
    leaves = tree_leaves(params)
    c = leaves[0].shape[0]
    ok = torch.ones(c, dtype=torch.bool, device=leaves[0].device)
    for x in _float_leaves(params):
        ok &= torch.isfinite(x.reshape(c, -1)).all(dim=1)
    return ok


def _poison_chains(chains, params: PyTree) -> None:
    """NaN the float leaves of ``chains`` (fault injection), in place."""
    for x in _float_leaves(params):
        for c in chains:
            x[c].fill_(float("nan"))


def _ring_of(tree) -> Optional[RingBuffer]:
    """The iterate ring inside a transform-chain state, or None."""
    if isinstance(tree, RingBuffer):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            found = _ring_of(t)
            if found is not None:
                return found
    return None


def _as_saved_ints(t: torch.Tensor) -> torch.Tensor:
    """The port's int64 host counters (ring heads) as the JAX package's
    int32."""
    return t.to(torch.int32) if t.dtype == torch.int64 else t


@dataclass
class ClusterEngine:
    """Chunked executor for a C-chain async-SGLD ensemble.

    ``batch_fn(key) -> batch`` (optional) makes an independent minibatch
    per (commit, chain) from its own PRNG key, the reference's: a chunk of
    ``n`` commits takes ``key, sub = split(key)`` of ``run``'s ``key`` and
    ``split(sub, n * C)`` in ``(commit, chain)`` order.  Explicit
    ``batches`` passed to :meth:`run` go to every chain unless
    ``per_chain_batches=True`` (then their second axis is the chain axis);
    with neither, every commit gets a ``(1,)`` zero tensor (batchless
    oracles, as the JAX engine).

    ``batch_policy``: ``"fixed"`` (one batch a commit), ``"inverse-speed"``
    (per-commit sizes from the schedules' ``batch_sizes``) or
    ``"explicit"`` (sizes passed to :meth:`run`, snapped up the
    ``buckets`` ladder); the last two consume masked windows of the
    ``data=`` stream and need the per-example oracle contract
    (``samplers.sgld(..., base_batch=...)``).

    ``worker_rng`` derives each commit's keys from ``(chain key, worker_id,
    worker-local slot)`` (:func:`~repro_torch.cluster.ensemble.worker_keys`)
    instead of splitting the carried key.

    ``health_check=True`` carries a sticky per-chain health mask
    (:class:`HealthState`): a chain whose iterate goes NaN/Inf is
    quarantined — its later commits are masked — and, with
    ``respawn=True``, recloned from a healthy donor chain with a fresh
    ``fold_in`` key at the next chunk boundary.  Both default off.

    ``mesh`` (a ``DeviceMesh`` with a ``chain_axis`` axis that divides
    ``num_chains``) places the chains over several ranks; every rank of
    the mesh calls the same methods with the same arguments.  A placed
    state's ``params`` and transform state are ``DTensor`` leaves, its
    ``key`` the rank's block of keys; a :class:`HealthState`'s mask holds
    every chain between chunks.
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
    respawn: bool = True
    mesh: Any = None
    chain_axis: str = "data"
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
        self._block = slice(0, self.num_chains)
        if self.mesh is not None:
            self._block = chain_block(self.mesh, self.chain_axis, self.num_chains)
        self._counters = _counters("ClusterEngine")
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
        self._m_faults = reg.counter(
            "faults.injected", "fault events injected (lost commits + NaN poisons)")
        self._m_quarantined = reg.counter(
            "chains.quarantined", "chains newly quarantined by the sticky health mask")
        self._m_respawned = reg.counter(
            "chains.respawned", "quarantined chains respawned from a healthy donor")
        self._m_unhealthy = reg.gauge("chains.unhealthy", "chains currently quarantined")

    @property
    def num_traces(self) -> int:
        """Distinct chunk layouts run so far — (batch layout, chunk length),
        and for masked windows (ladder rung, chunk length) — what the JAX
        engine counts as jit traces; a view over the engine's instrument
        counters."""
        return self._counters.traces

    def _see_layout(self, program: str, layout) -> None:
        """Report a chunk layout to the counters the first time it runs."""
        if layout not in self._layouts:
            self._layouts.add(layout)
            self._counters.trace(program)

    # -- init / export ----------------------------------------------------------
    def init(self, params: PyTree, key, *, jitter: float = 0.0) -> SamplerState:
        """C-chain ensemble state; chain ``c``'s key is ``split(key, C)[c]``.
        Placed, each rank builds only its block of chains."""
        state = init_ensemble(self.sampler, params, key, num_chains=self.num_chains,
                              jitter=jitter, chains=self._block)
        return self._place(state)

    # -- placement -------------------------------------------------------------------
    def _place(self, tree):
        """The rank's rows placed over the mesh (unchanged without one)."""
        if self.mesh is None:
            return tree
        return place_chains(tree, self.mesh, self.chain_axis)

    def _gather_host(self, rows: np.ndarray, dim: int = 0) -> np.ndarray:
        """A host array of the rank's chains (on axis ``dim``) gathered
        over the chain axis: every rank gets every chain's."""
        if self.mesh is None:
            return rows
        t = torch.from_numpy(np.ascontiguousarray(rows))
        return gather_rows(t, self.mesh, self.chain_axis, dim).numpy()

    def save_ensemble(self, state, path: str) -> None:
        """Export the chain bank: the chain-stacked parameters in the
        ensemble layout :func:`~repro_torch.checkpoint.restore_ensemble`
        (and so ``DecodeEngine.from_checkpoint``) restores — a model's
        per-chain axis of 1 dropped, as the JAX package lays a bank out —
        with the commit counter as the checkpoint step."""
        from repro_torch.checkpoint import save_checkpoint
        from repro_torch.weights import drop_unit_chain

        params = self._place(drop_unit_chain(local(state.params)))
        save_checkpoint(path, params, step=int(state.step))

    # -- schedule normalisation ---------------------------------------------------
    def _compile_schedule(self, schedule: ScheduleLike, steps: int):
        """-> (extra dict of (steps, C) arrays, commit_times | None,
        batch_info (sizes, offsets) | None); ``extra`` holds ``rv`` (read
        versions), under ``worker_rng`` ``wid`` / ``slot``, and ``alive``
        (commit liveness) only when a chaos schedule lost a commit."""
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
        live = stack_liveness(scheds, steps)
        if live is not None:
            extra["alive"] = live
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

    # -- one commit, with the fault guards -------------------------------------------
    def _advance(self, carry, batches: list, ex: dict):  # torchlint: hot
        """One population commit.  ``ex``: this commit's row of every
        schedule input (``rv``, and ``wid`` / ``slot`` / ``alive`` /
        ``poison`` where present).

        Without faults (no ``alive``, no ``poison``, no health mask) it is
        :meth:`Sampler.step_chains`.  Otherwise, with the JAX package's
        rule ``keep = health & finite & alive``:

        - a chain with ``alive`` False, or already quarantined, is masked
          before the commit: its ring does not push, the fused kernel skips
          its row, and its other state keeps its old rows;
        - a poisoned chain's new iterate is NaN'd after its update, before
          the finiteness test;
        - under ``health_check`` the host reads the commit's ``(C,)``
          non-finite flags (the fused kernel's, else ``torch.isfinite``); a
          chain that went non-finite is quarantined and restored: its
          iterate from the ring slot its push just wrote (its pre-commit
          iterate; with no ring, from a copy made before the commit), its
          ring head rolled back — the slot the push overwrote is not
          restored (the chain reads its ring no more until a respawn
          replaces it) — and its other state from the old rows;
        - keys of chains not kept stay frozen; the commit counter always
          advances (a masked commit uses up its version slot)."""
        if isinstance(carry, HealthState):
            s, health = carry.state, carry.health
        else:
            s, health = carry, None
        C = len(s.key)  # the rank's chains when placed
        delays = s.step - ex["rv"]  # endogenous
        keys = None
        if self.worker_rng:
            keys = [worker_keys(k, w, sl) for k, w, sl in zip(s.key, ex["wid"], ex["slot"])]
        alive, poison = ex.get("alive"), ex.get("poison")
        if health is None and alive is None and poison is None:
            new, aux, _ = self.sampler.commit(s, batches, delays, keys)
            return new, aux
        run = np.ones(C, bool)
        if health is not None:
            run &= health
        if alive is not None:
            run &= alive
        skip = None if run.all() else ~run
        backup = None
        if health is not None and _ring_of(s.inner) is None:
            backup = tree_map(torch.clone, s.params)  # no ring to restore from
        new, aux, flags = self.sampler.commit(s, batches, delays, keys, skip=skip,
                                              check=health is not None)
        keep = np.ones(C, bool)
        if poison is not None:
            _poison_chains(np.flatnonzero(poison & run), new.params)
        if health is not None:
            bad = np.zeros(C, bool) if poison is None else poison.copy()
            if flags is None:  # no fused commit: test the chain-stacked result
                flags = ~_finite_chains(new.params)
            # the commit's one host read, by design: quarantine decides on the host
            bad |= flags.cpu().numpy().astype(bool) & run  # torchlint: disable=TL004
            health = health & ~bad
            keep &= health
        if alive is not None:
            keep &= alive
        if not keep.all():
            self._undo(s, new, run, keep, backup)
        key = new.key if keys is not None else \
            [n if k else o for n, o, k in zip(new.key, s.key, keep)]
        out = SamplerState(new.params, new.step, key, new.inner)
        return (out if health is None else HealthState(out, health)), aux

    @staticmethod
    def _undo(old: SamplerState, new: SamplerState, run, keep, backup) -> None:
        """Give the chains not kept their pre-commit state back, in place
        on ``new``.  A tensor the commit replaced (out of place) gets its
        old rows back; one it updated in place (the fused iterate) holds
        the old rows still for a masked chain, and takes them from the ring
        slot just pushed (or ``backup``) for a chain that ran and was
        rejected.  The ring head is replaced by every push, so restoring
        its old rows rolls a rejected chain's head back and leaves a masked
        one's where it was."""
        undone = np.flatnonzero(~keep)
        rejected = np.flatnonzero(run & ~keep)
        ring = _ring_of(new.inner)
        slots = heads(ring) if ring is not None else None
        hist = tree_leaves(ring.history) if ring is not None else None
        for i, (n, o) in enumerate(zip(tree_leaves(new.params), tree_leaves(old.params))):
            if n is not o:
                for c in undone:
                    n[c].copy_(o[c])
            elif backup is not None:
                src = tree_leaves(backup)[i]
                for c in rejected:
                    n[c].copy_(src[c])
            else:
                for c in rejected:
                    n[c].copy_(hist[i][c, slots[c]])

        def restore(n, o):
            if n is not o:
                for c in undone:
                    n[c].copy_(o[c])
            return n

        map_tensors(restore, new.inner, old.inner)

    # -- one chunk -------------------------------------------------------------------
    def _run_chunk(self, carry, batches: list, extra: dict):
        """``batches``: one list of C batches a commit of the chunk."""
        auxs = []
        for j, chain_batches in enumerate(batches):
            carry, aux = self._advance(carry, chain_batches,
                                       {k: v[j] for k, v in extra.items()})
            if self.collect_aux:
                auxs.append(aux)
        return carry, _to_host(auxs)

    def _run_placed_chunk(self, carry, batches: list, extra: dict):
        """One chunk of a placed run: the chunk body on the rank's local
        rows (its block of the health mask), placed back after; under
        ``health_check`` the mask is gathered over the chain axis (one
        collective a chunk), and a collected aux likewise."""
        health = isinstance(carry, HealthState)
        state = local(carry.state if health else carry)
        lc = HealthState(state, carry.health[self._block]) if health else state
        lc, aux = self._run_chunk(lc, batches, extra)
        out = self._place(lc.state if health else lc)
        if health:
            out = HealthState(out, self._gather_host(lc.health))
        if aux is not None:  # (n, C_local, ...) host arrays
            aux = tree_map(lambda a: self._gather_host(a, dim=1), aux)
        return out, aux

    # -- fault tolerance --------------------------------------------------------------
    def _as_carry(self, state):
        """The carry :meth:`run` drives: under ``health_check`` a
        :class:`HealthState` (every chain healthy)."""
        if not self.health_check or isinstance(state, HealthState):
            return state
        return HealthState(state, np.ones(self.num_chains, bool))

    def _heal(self, carry: HealthState, prev_health: list) -> HealthState:
        """Chunk-boundary quarantine bookkeeping and respawn: each
        quarantined chain is recloned from a healthy donor (round-robin) —
        params, transform state and ring head — and its frozen key
        ``fold_in``-minted into a fresh stream, all a function of the
        carry, so a resumed run respawns as the uninterrupted one.  With
        ``respawn=False``, or no healthy chain left, nothing is cloned."""
        health = carry.health
        sick = np.flatnonzero(~health)
        newly = int((~health & prev_health[0]).sum())
        prev_health[0] = health
        if newly:
            self._m_quarantined.inc(newly)
        self._m_unhealthy.set(float(sick.size))
        if sick.size == 0 or not self.respawn:
            return carry
        donors = np.flatnonzero(health)
        if donors.size == 0:
            return carry  # total loss: nothing healthy left to clone
        donor = donors[np.arange(sick.size) % donors.size]
        state = carry.state
        lo, hi = self._block.start, self._block.stop

        with _span("faults.respawn", chains=[int(i) for i in sick],
                   donors=[int(i) for i in donor]):
            self._move_rows(local((state.params, state.inner)), sick, donor)
            keys = list(state.key)
            for a in sick:  # the rank that holds a sick chain mints its key
                if lo <= a < hi:
                    keys[a - lo] = rng.fold_in(keys[a - lo], _RESPAWN_TAG)
            healed = SamplerState(state.params, state.step, keys, state.inner)
            health = np.ones_like(health)
        self._m_respawned.inc(int(sick.size))
        prev_health[0] = health
        return HealthState(healed, health)

    def _move_rows(self, tensors, sick, donor) -> None:
        """Respawn's copies: each sick chain's rows of every (local) tensor
        — its ring head, on the host, too — replaced by its donor's.  A
        donor on the sick chain's own rank (every donor, unplaced) is
        copied there; otherwise the donor's rank broadcasts the row over the
        chain axis and the sick chain's rank takes it — every rank walks the
        same pairs, in order."""
        import torch.distributed as dist

        per = self._block.stop - self._block.start
        me = self._block.start // per
        rows: list = []
        map_tensors(lambda t: rows.append(t), tensors)
        for a, b in zip(sick, donor):
            ra, rb = int(a) // per, int(b) // per
            if ra == rb:
                if me == ra:
                    for t in rows:
                        t[a - ra * per].copy_(t[b - rb * per])
                continue
            group = self.mesh.get_group(self.chain_axis)
            src = dist.get_global_rank(group, rb)
            for t in rows:
                buf = (t[b - rb * per] if me == rb else t[0]).contiguous()
                buf = buf.to(self.mesh.device_type, copy=True)
                dist.broadcast(buf, src=src, group=group)
                if me == ra:
                    t[a - ra * per].copy_(buf)

    def _carry_tree(self, carry):
        """The carry in the JAX package's layout, for a run checkpoint: the
        commit counter as a ``(C,)`` int32, the keys as ``(C, 2)`` uint32,
        ring heads as int32; paths ``carry##.state##.params...``,
        ``carry##.health`` as the JAX carry's.  Placed, the keys and ring
        heads are gathered over the chain axis (the placed tensors stay
        placed: the checkpoint gathers them)."""
        s = carry.state if isinstance(carry, HealthState) else carry
        C = self.num_chains

        def heads(t):  # placed: the plain tensors are the rank's ring heads
            if self.mesh is None or is_placed(t):
                return _as_saved_ints(t)
            return _as_saved_ints(torch.from_numpy(self._gather_host(t.numpy())))

        keys = self._gather_host(np.asarray(s.key, np.int64).reshape(-1, 2))
        state = SamplerState(params=s.params, step=np.full(C, s.step, np.int32),
                             key=keys.astype(np.uint32),
                             inner=map_tensors(heads, s.inner))
        if isinstance(carry, HealthState):
            return HealthState(state, np.asarray(carry.health, bool))
        return state

    def _save_run_checkpoint(self, path: str, carry, done: int, base) -> None:
        from repro_torch.checkpoint import save_checkpoint

        save_checkpoint(path, {"carry": self._carry_tree(carry), "manifest": {
            "done": np.asarray(done, np.int64),
            "base": np.asarray(base, np.int64)}}, step=int(done))

    def _load_run_checkpoint(self, path: str, state):
        """-> (carry, done, base): the checkpoint's carry copied into the
        tensors of ``state`` (in place, on their devices), the commits it
        had done and the run's base commit counters."""
        from repro_torch.checkpoint import restore_checkpoint

        template = self._as_carry(state)
        like = {"carry": self._carry_tree(template), "manifest": {
            "done": np.zeros((), np.int64), "base": np.zeros(self.num_chains, np.int64)}}
        placed = self.mesh is not None
        tree = restore_checkpoint(path, like, device=None if placed else "cpu")
        saved, dst = tree["carry"], template
        if isinstance(template, HealthState):
            saved, dst = saved.state, template.state
        steps = saved.step.numpy()
        if not (steps == steps[0]).all():
            raise ValueError(f"{path}: the chains' commit counters differ: {steps}")
        block = self._block

        def put(d, r):  # placed: the rank's rows (a ring head: its block of heads)
            if is_placed(d):
                return d.to_local().copy_(r.to_local())
            return d.copy_(r[block] if placed and d.dim() else r)

        tree_map(put, dst.params, saved.params)
        map_tensors(put, dst.inner, saved.inner)
        keys = [tuple(int(v) for v in row)
                for row in saved.key.numpy().astype(np.uint32)[block]]
        carry = SamplerState(dst.params, int(steps[0]), keys, dst.inner)
        if isinstance(template, HealthState):
            carry = HealthState(carry, tree["carry"].health.numpy().astype(bool))
        return (carry, int(tree["manifest"]["done"]),
                tree["manifest"]["base"].numpy().astype(np.int64))

    # -- host driver -----------------------------------------------------------------
    def run(self, state: SamplerState, *, steps: int, schedule: ScheduleLike = None,
            batches: Optional[PyTree] = None, key=None,
            data: Optional[PyTree] = None, batch_sizes=None, poison=None,
            checkpoint_path: Optional[str] = None, checkpoint_every=None):
        """Advance every chain ``steps`` commits under ``schedule``: one
        :class:`~repro_torch.cluster.schedule.WorkerSchedule` (every
        chain), C per-chain schedules, a raw delay array (``(steps,)`` or
        ``(steps, C)``), or ``None`` (synchronous).  Returns ``(state,
        aux)`` — the state a :class:`HealthState` under ``health_check`` —
        aux stacked ``(steps, C, ...)`` when ``collect_aux``; hooks see
        ``commit_time`` (and under a non-fixed policy ``grad_evals``) in
        their aux.  The state's tensors are updated in place.

        Under a non-fixed ``batch_policy``, ``data=`` is the example stream
        (a tree with a leading row axis): commit ``k`` of chain ``c``
        consumes rows ``[offset, offset + size)``, wrapping modulo the
        stream and restarting at 0 on every call, as a bucket-padded
        :class:`~repro_torch.samplers.transforms.MaskedBatch`.  ``key``: a
        PRNG key, or an int seed of one, for ``batch_fn`` (a
        ``torch.Generator`` is refused).

        A run on an advanced state (a continuation) rebases the schedule's
        read versions (and, under ``worker_rng``, worker slots) onto the
        state's commit counter, so each commit's staleness is the
        schedule's tau_k.

        Fault knobs (all opt-in):

        - a chaos schedule carrying an ``alive`` mask executes lost commits
          as masked no-ops (the version slot still goes);
        - ``poison``: a ``(steps, C)`` bool mask NaN'ing chain iterates at
          chosen commits (deterministic fault injection);
        - ``checkpoint_path``: an atomic resumable checkpoint (carry +
          manifest) at every chunk boundary, or every
          ``checkpoint_every`` commits (and at the end);
          :meth:`resume` continues bitwise from the newest one."""
        return self._run(state, steps=steps, schedule=schedule, batches=batches,
                         key=key, data=data, batch_sizes=batch_sizes, poison=poison,
                         checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every, start=0, base_steps=None)

    def resume(self, checkpoint_path: str, state: SamplerState, *, steps: int, **kw):
        """Continue an interrupted ``run(checkpoint_path=...)`` bitwise.

        ``state`` is an initial ensemble state like the interrupted run's
        (it supplies the carry's structure and tensors: the checkpoint is
        copied into them); the other arguments repeat the interrupted
        call.  A missing checkpoint file starts the run from scratch
        (writing checkpoints to the same path); a truncated or bit-flipped
        one raises :class:`~repro_torch.checkpoint.CorruptCheckpointError`.
        The remaining commits run on the same chunk grid; ``batch_fn``'s
        key stream skips one ``split`` per completed chunk, as the
        reference's does, so the batches are the unbroken run's.
        Returns ``(state, aux)``, aux covering only the commits run."""
        if not os.path.exists(checkpoint_path):
            return self.run(state, steps=steps, checkpoint_path=checkpoint_path, **kw)
        carry, done, base = self._load_run_checkpoint(checkpoint_path, state)
        if done >= steps:
            return carry, None
        return self._run(carry, steps=steps, start=done, base_steps=base,
                         checkpoint_path=checkpoint_path, **kw)

    def _run(self, state, *, steps, schedule=None, batches=None, key=None, data=None,
             batch_sizes=None, poison=None, checkpoint_path=None,
             checkpoint_every=None, start=0, base_steps=None):
        C = self.num_chains
        extra, commit_times, batch_info = self._compile_schedule(schedule, steps)
        staleness = np.arange(steps, dtype=np.int64)[:, None] - extra["rv"]
        max_delay = int(staleness.max(initial=0))
        validate_staleness(max_delay, state.inner, context="schedule")
        self._m_staleness.observe_many(staleness.ravel())
        self._m_commits.inc(staleness.size)
        self._m_max_stale.set(float(max_delay))
        if poison is not None:
            pz = np.asarray(poison, bool)
            if pz.shape != (steps, C):
                raise ValueError(f"poison must be (steps, C) = ({steps}, {C}), "
                                 f"got {pz.shape}")
            if pz.any():
                extra["poison"] = pz
        n_faults = ((int((~extra["alive"]).sum()) if "alive" in extra else 0)
                    + (int(extra["poison"].sum()) if "poison" in extra else 0))
        if n_faults:
            self._m_faults.inc(n_faults)
        # schedule versions are relative to the run's first commit: rebase
        # them onto the initial commit counter (the state's on a fresh run,
        # the manifest's on a resume)
        base = (np.full(C, int(state.step), np.int64) if base_steps is None
                else np.asarray(base_steps, np.int64))
        extra["rv"] = (extra["rv"] + base[None, :]).astype(np.int64)
        if self.worker_rng:
            extra["slot"] = (extra["slot"] + base[None, :]).astype(np.int64)
        block = self._block  # placed: the rank's columns of every schedule input
        extra = {k: v[:, block] for k, v in extra.items()}
        n_local = block.stop - block.start

        carry = self._as_carry(state)
        use_health = isinstance(carry, HealthState)
        chunk_post = None
        if use_health or checkpoint_path is not None:
            prev_health = [carry.health if use_health else None]
            last_saved = [start]

            def chunk_post(done: int, st):
                if use_health:
                    st = self._heal(st, prev_health)
                if checkpoint_path is not None:
                    absolute = start + done
                    if (checkpoint_every is None
                            or absolute - last_saved[0] >= checkpoint_every
                            or absolute >= steps):
                        self._save_run_checkpoint(checkpoint_path, st, absolute, base)
                        last_saved[0] = absolute
                return st

        pos = [start]  # the next chunk's first commit (absolute)
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
            host_aux = {"grad_evals": np.cumsum(sizes.astype(np.int64), axis=0)[start:]}
            sizes, offs = sizes[:, block], offs[:, block]
            device = tree_leaves(data)[0].device

            def gen(key, n):
                a = pos[0]
                pos[0] += n
                pad = bucket_size(int(sizes[a:a + n].max()), self.buckets)
                self._see_layout(f"masked_chunk[pad={pad}]", ("masked", pad, n))
                out = []
                for k in range(a, a + n):
                    idx = torch.remainder(to_device(offs[k], device)[:, None]
                                          + torch.arange(pad, device=device), n_data)
                    rows = tree_map(lambda x: x[idx], data)  # (C, pad, ...)
                    out.append([MaskedBatch(chain_at(rows, c), int(sizes[k, c]))
                                for c in range(n_local)])
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
                key = rng.as_key(key)
                for _ in range(start // self.chunk_size):
                    # resume: one split was taken per completed chunk
                    # (checkpoints land on chunk boundaries)
                    key, _ = rng.split(key)
            zero = torch.zeros(1)

            def gen(key, n):
                a = pos[0]
                pos[0] += n
                self._see_layout(f"chunk[{layout}]", (layout, n))
                if self.batch_fn is not None and batches is None:
                    # one key a (commit, chain), the reference's order; a
                    # placed rank makes only its block's batches
                    key, sub = rng.split(key)
                    keys = rng.split(sub, n * C)
                    return key, [[self.batch_fn(keys[j * C + c])
                                  for c in range(block.start, block.stop)]
                                 for j in range(n)]
                out = []
                for k in range(a, a + n):
                    if batches is not None:
                        b = tree_map(lambda x: x[k], batches)
                        out.append([chain_at(b, c) for c in range(block.start, block.stop)]
                                   if per_chain else [b] * n_local)
                    else:
                        out.append([zero] * n_local)
                return key, out

        if start:
            # resume: drop the commits done (checkpoints land on chunk
            # boundaries, so the rest keeps the uninterrupted run's grid)
            extra = {k: v[start:] for k, v in extra.items()}
            if commit_times is not None:
                commit_times = commit_times[start:]
        return drive_chunks(
            self._run_chunk if self.mesh is None else self._run_placed_chunk, carry,
            steps=steps - start, chunk_size=self.chunk_size,
            hooks=self.hooks, collect_aux=self.collect_aux, extra=extra,
            gen_batches=gen, key=key, commit_times=commit_times,
            host_aux=host_aux, chunk_post=chunk_post)
