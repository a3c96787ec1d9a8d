"""The request-level serving front door the engines share (port of
``repro.cluster.api``).

- :class:`Request` — one sequence: prompt tokens, a per-request generation
  budget, an optional sampling seed, a scheduling priority and an optional
  deadline;
- :class:`Completion` — its result: generated tokens, optional per-token
  BMA log-probs, a finish reason, a status and host-clock timing;
- :class:`Endpoint` — the shared ``submit()`` / ``drain()`` surface, with
  ``max_waiting`` backpressure;
- :class:`BankEngine` — the plumbing every chain-bank engine shares: bank
  validation, chain counting, the instrument counters
  (:func:`~repro_torch.analysis.instrument.counters`), host pad scratch and
  the request queue, and
  the constructors from a cluster state (``from_cluster``, serving degraded
  from the healthy chains) and from a checkpoint (``from_checkpoint``),
  which bind the engine's front argument (``model`` on the decode engines,
  ``predict_fn`` on :class:`~repro_torch.cluster.serve.ServeEngine`).

Differences from the JAX package: ``Request.key`` is an int seed (``None``
= greedy) where JAX carries a PRNG key, and tokens are sampled by
:func:`sample_tokens`, a counter-based Gumbel-max whose noise is a hash of
(seed, absolute position, token id) — deterministic on any device, so a
preempted request replays identically.  The sampled tokens are not the
JAX package's.

Placement (``mesh=``, a ``torch.distributed.device_mesh.DeviceMesh``): the
bank's chains are split over ``chain_axis`` and replicated over the other
mesh axes (:meth:`BankEngine._shard_bank`); each rank runs every chain of
its block, and the per-chain block of a step — logits ``(C, B, V)``,
predictions ``(C, Q, ...)`` — is all-gathered over the chain axis before
the same replicated reduce runs on every rank
(:meth:`BankEngine._all_chains`, the JAX package's ``_wrap_bma``), so every
rank takes the same token.  Every rank of the mesh submits the same
requests in the same order.

A 2-D bank (``shard_params=True`` on the decode engines) also splits each
chain's tensors over the mesh's ``model`` axis by
:func:`~repro_torch.models.common.partition_tree`'s specs through
:func:`~repro_torch.models.common.sanitize_spec` (a leaf's placements
``P(chain_axis, *spec)``): every rank runs its heads, MLP columns, experts
and vocabulary slice (``Model(cfg, mesh=...)``), the row-parallel products
are all-reduced over ``model``, and a step's logits are gathered over
``model`` (the vocabulary) and then over the chain axis before the same
reduce.  The partial sums' order is not the whole bank's, so a 2-D bank's
log-probs agree with an unplaced one's to rounding, not bit for bit (the
JAX package's "2-D banks trade the bitwise guarantee"); every rank still
takes the same token, from the same gathered bits.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.analysis.instrument import Counters as _Counters
from repro_torch.analysis.instrument import counters as _counters
from repro_torch.obs.metrics import registry as _registry
from repro_torch.obs.trace import now as _now
from repro_torch.utils import (
    chain_block,
    chain_placements,
    gather_chains,
    gather_rows,
    is_placed,
    local,
    local_block,
    map_local,
    paired_leaves,
    place_chains,
    resolve_device,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

PyTree = Any

#: finish reasons a :class:`Completion` can carry
FINISH_LENGTH = "length"      # generated its full max_new_tokens budget
FINISH_QUERY = "query"        # predictive query: answered in one shot
FINISH_DEADLINE = "deadline"  # deadline expired (shed or cut short)

#: delivery status a :class:`Completion` can carry
STATUS_OK = "ok"            # full result
STATUS_TIMEOUT = "timeout"  # deadline hit mid-decode: partial tokens
STATUS_SHED = "shed"        # deadline hit before admission: no tokens

_REQUEST_IDS = itertools.count(1)


class QueueFullError(RuntimeError):
    """Backpressure: the engine's waiting queue is at ``max_waiting`` —
    the caller must drain (or step) before submitting more work."""


@dataclass
class Request:
    """One unit of serving work.

    ``tokens`` is a 1-D prompt token array for decode engines, or one query
    (any tree row) for predictive engines; ``max_new_tokens`` this
    request's own generation budget (0 = predictive query).  ``key`` is
    the sampling seed (an int; ``None`` = greedy).  Higher ``priority``
    admits first and may preempt lower-priority running slots.
    ``deadline_ms`` is a host-clock latency budget from submission
    (``None`` never expires).  ``request_id`` is stamped by
    :meth:`Endpoint.submit`.
    """

    tokens: Any
    max_new_tokens: int = 0
    key: Optional[int] = None
    priority: int = 0
    request_id: Optional[int] = None
    timing: dict = field(default_factory=dict)
    deadline_ms: Optional[float] = None


@dataclass
class Completion:
    """The finished result of one :class:`Request`: ``tokens`` the generated
    ``(n,)`` int32 host array, ``logits`` the per-token BMA log-prob block
    ``(n, V)`` when the engine returns logits, ``finish_reason``,
    ``timing`` (host seconds: ``submitted`` / ``admitted`` /
    ``first_token`` / ``finished``, plus ``evictions`` under preemption),
    ``stats`` the per-query :class:`~repro_torch.cluster.serve.ServeResult`
    row on predictive endpoints, and ``status`` (:data:`STATUS_OK`,
    :data:`STATUS_TIMEOUT` with the partial prefix, or :data:`STATUS_SHED`
    with no tokens)."""

    request_id: int
    tokens: np.ndarray
    logits: Optional[np.ndarray]
    finish_reason: str
    timing: dict
    stats: Optional[Any] = None
    status: str = STATUS_OK


class HostScratch:
    """Reusable host-side pad buffers, one per (bucket rung, leaf), so a
    steady request stream allocates nothing on the padding path
    (``allocs`` stops growing once every rung has been seen).  Every
    buffer creation is reported to ``counters`` (a
    :class:`~repro_torch.analysis.instrument.Counters` handle) when one is
    given."""

    def __init__(self, counters: Optional[_Counters] = None):
        self._bufs: dict = {}
        self.allocs = 0  # scratch-buffer creations, NOT per-request work
        self._counters = counters

    def get(self, key, shape, dtype) -> np.ndarray:
        """The scratch buffer for ``key`` (caller fills it)."""
        k = (key, tuple(shape), np.dtype(dtype).str)
        buf = self._bufs.get(k)
        if buf is None:
            buf = np.empty(shape, dtype)
            self._bufs[k] = buf
            self.allocs += 1
            if self._counters is not None:
                self._counters.pad_alloc()
        return buf

    def pad(self, x: np.ndarray, n: int, key=0) -> np.ndarray:
        """``x`` with its leading axis padded to ``n`` by edge-replicating
        the last row, written into the reused scratch; ``x`` itself when it
        already has ``n`` rows (the copy to the device leaves it intact)."""
        q = x.shape[0]
        if q == n:
            return x
        buf = self.get(("pad", key), (n,) + x.shape[1:], x.dtype)
        buf[:q] = x
        buf[q:] = x[-1:]
        return buf


class Endpoint:
    """The ``submit()`` / ``drain()`` surface every serving engine exposes.

    ``submit`` enqueues one :class:`Request` and returns its id; ``drain``
    runs everything pending to completion and returns the
    :class:`Completion` list.  Subclasses implement ``_drain(requests)``.
    """

    def submit(self, request: Request) -> int:
        """Enqueue one request; returns its stamped ``request_id``.

        Engines with a ``max_waiting`` bound reject submissions once the
        waiting queue is full — :class:`QueueFullError`, counted under
        ``requests.rejected``."""
        limit = getattr(self, "max_waiting", None)
        if limit is not None and self._queue_depth() >= limit:
            _registry().counter(
                "requests.rejected",
                "submissions refused by max_waiting backpressure").inc()
            raise QueueFullError(
                f"waiting queue holds {self._queue_depth()} requests "
                f"(max_waiting={limit}); drain() or step() before "
                "submitting more")
        if request.request_id is None:
            request.request_id = next(_REQUEST_IDS)
        request.timing.setdefault("submitted", _now())
        self._validate_request(request)
        self._pending.append(request)
        return request.request_id

    def drain(self) -> list:
        """Run every pending request to completion; returns Completions."""
        reqs, self._pending = list(self._pending), []
        return self._drain(reqs)

    def _queue_depth(self) -> int:
        return len(self._pending)

    def _validate_request(self, request: Request) -> None:
        del request  # engines override with their admission checks

    def _drain(self, requests: list) -> list:
        raise NotImplementedError


class BankEngine(Endpoint):
    """Shared plumbing for engines serving a chain-stacked parameter bank:
    the engines are dataclasses with ``params`` / ``device`` / ``mesh`` /
    ``chain_axis`` fields and a front field, :attr:`_FRONT_FIELD`
    (``model`` on the decode engines, ``predict_fn`` on the predictive
    one), which the constructors' ``front`` argument binds."""

    #: the dataclass field the constructors' ``front`` argument binds to
    _FRONT_FIELD = "model"

    # -- constructors -----------------------------------------------------------
    @classmethod
    def from_cluster(cls, state, front=None, **kw):
        """Serve straight from a ClusterEngine state — or any chain-stacked
        parameter tree.  ``front`` is the engine's front argument (``model``
        or ``predict_fn``; also by keyword).  A model's ensemble state has
        leaves ``(C, 1, ...)`` (each chain a bank of one); the bank is
        served as ``(C, ...)``.

        A :class:`~repro_torch.cluster.executor.HealthState` (any state
        carrying a ``health`` mask) serves **degraded**: quarantined chains
        are dropped from the bank and the BMA averages the survivors.  An
        all-quarantined bank raises.

        A placed state (a placed ``ClusterEngine``'s) serves placed, on its
        own mesh unless ``mesh=`` is given; each rank keeps its rows.  With
        quarantined chains its rows are gathered whole on every rank
        (:func:`~repro_torch.utils.gather_chains`), the survivors kept and
        placed again over the same chain axis, as the reference indexes its
        sharded bank and places the survivors; where they do not divide
        over the axis, the reference's ``must be divisible`` refusal.  For
        that while each rank holds the whole bank, quarantined rows too,
        and then its block of the survivors: a bank placed because it
        does not fit on one rank is best healed by respawn instead."""
        params = getattr(state, "params", state)
        health = getattr(state, "health", None)
        leaf = tree_leaves(params)[0]
        if is_placed(leaf) and "mesh" not in kw:
            kw["mesh"] = leaf.device_mesh
            kw["chain_axis"] = leaf.device_mesh.mesh_dim_names[
                next(i for i, p in enumerate(leaf.placements) if p.is_shard())]
        if health is not None:
            h = np.asarray(health, bool)
            if not h.any():
                raise ValueError("every chain is quarantined — no healthy bank to serve")
            if not h.all():
                keep = np.flatnonzero(h)
                if is_placed(leaf):  # survivors that do not divide: refused before the gather
                    chain_block(kw["mesh"], kw.get("chain_axis", "data"), keep.size)
                    params = gather_chains(params)
                params = tree_map(lambda x: x[torch.from_numpy(keep).to(x.device)],
                                  params)
                _registry().gauge("chains.unhealthy", "chains currently "
                                  "quarantined").set(float(h.size - keep.size))
        if isinstance(params, dict) and "embed" in params and params["embed"]["w"].dim() == 4:
            params = map_local(lambda t: t[:, 0], params)  # (C, 1, ...) -> (C, ...)
        if front is not None:
            kw.setdefault(cls._FRONT_FIELD, front)
        return cls(params=params, **kw)

    @classmethod
    def from_checkpoint(cls, path: str, like=None, front=None, *,
                        num_chains: Optional[int] = None, **kw):
        """Restore a bank saved by :meth:`ClusterEngine.save_ensemble` (or
        broadcast a single-model checkpoint to ``num_chains``) and serve it.

        ``(path, like, front, ...)``: ``like`` is the *single-chain*
        parameter structure (shapes only; the port's one chain, a bank of
        one, will do, and so will a ``meta`` tree), ``front`` the engine's
        front argument — a model or config, or a predict fn — also by
        keyword.  The other order, ``(path, front, like)``, is recognised
        (a model, config or function in the ``like`` seat) and swapped.
        The bank is restored onto the engine's ``device``; with ``mesh=``
        each rank reads the file one leaf at a time and keeps only its
        rows, and with ``shard_params=True`` only its block of each chain's
        tensors too (the 2-D layout, restored straight into place)."""
        from repro_torch.checkpoint import restore_ensemble
        from repro_torch.weights import drop_unit_chain

        if _looks_like_front(like) and not _looks_like_front(front):
            like, front = front, like  # (path, front, like) order
        if front is not None:
            kw.setdefault(cls._FRONT_FIELD, front)
        dev = resolve_device(kw.get("device", "cuda"))
        mesh, axis = kw.get("mesh"), kw.get("chain_axis", "data")
        specs = None
        if kw.get("shard_params") and mesh is not None:
            from repro_torch.models.common import model_specs

            cfg = kw[cls._FRONT_FIELD]
            specs = model_specs(getattr(cfg, "cfg", cfg), mesh, axis)
        params = restore_ensemble(path, drop_unit_chain(like), num_chains=num_chains,
                                  device=dev, mesh=mesh, chain_axis=axis, specs=specs)
        return cls(params=params, **kw)

    def _init_bank(self) -> None:
        """Validate the bank, count chains, sort the prompt ladder, and wire
        the instrument counters (labelled with the engine's class name),
        the host pad scratch and the request queue."""
        leaves = tree_leaves(self.params)
        if not leaves:
            raise ValueError("params bank is empty")
        self.num_chains = int(leaves[0].shape[0])
        devices = {t.device for t in leaves}
        if devices != {self.device}:
            raise ValueError(f"the bank lies on {sorted(map(str, devices))}, "
                             f"the engine on {self.device}")
        for name in ("buckets", "prompt_buckets"):
            ladder = getattr(self, name, None)
            if ladder is not None:
                setattr(self, name, sorted(int(b) for b in ladder))
        self._counters = _counters(type(self).__name__)
        self._scratch = HostScratch(self._counters)
        self._pending: list = []
        self._rungs: set = set()

    def _shard_bank(self) -> None:
        """Place the bank (the JAX package's ``_shard_bank`` and
        ``_bank_shardings``).  Without a mesh the bank serves as it is.
        With one, the chain count must divide over ``chain_axis`` (the JAX
        package's message), and with ``shard_params`` each leaf is also
        split over ``model`` as its sanitized spec says
        (:func:`~repro_torch.models.common.model_specs`; the JAX package's
        ``_bank_shardings`` does not sanitize, where DTensor would split an
        undivided dimension unevenly).  A placed bank (``from_cluster`` of
        a placed state, a placed restore) is kept if every leaf is placed
        as the engine would place it; a whole one is cut to the rank's
        block; a bank placed on the chain axis alone (a placed cluster's
        state) is cut to a 2-D one on each rank, from its own rows.
        ``_bank`` is the rank's local bank the model runs on,
        ``_local_chains`` its chain count."""
        shard = getattr(self, "shard_params", False)
        leaves = tree_leaves(self.params)
        placed = [is_placed(x) for x in leaves]
        self._bank, self._local_chains = self.params, self.num_chains
        if self.mesh is None:
            if shard:
                raise ValueError("shard_params=True splits each chain over a mesh's "
                                 "'model' axis: pass mesh=")
            if any(placed):
                raise ValueError("a placed bank needs the engine's mesh= (and "
                                 "chain_axis=) to serve from")
            return
        block = chain_block(self.mesh, self.chain_axis, self.num_chains)
        specs = None
        if shard:
            from repro_torch.models.common import model_specs

            specs = model_specs(self._model.cfg, self.mesh, self.chain_axis)
        want = [chain_placements(self.mesh, self.chain_axis, spec=s) for s in
                (paired_leaves(self.params, specs) if shard else [None] * len(leaves))]
        rows = chain_placements(self.mesh, self.chain_axis)
        if all(placed) and shard and all(
                x.device_mesh == self.mesh and list(x.placements) == rows for x in leaves):
            # placed on the chain axis alone (a placed ClusterEngine's state):
            # each rank holds its chains whole, so it cuts its block of each
            # chain's tensors from its own rows, with no collective
            from torch.distributed.tensor import DTensor, Replicate

            cut = [DTensor.from_local(local_block(x.to_local(), self.mesh, [
                       Replicate() if p.is_shard() and p.dim == 0 else p for p in w]).clone(),
                       self.mesh, w, run_check=False) for x, w in zip(leaves, want)]
            self.params = tree_unflatten(tree_flatten(self.params)[1], cut)
        elif all(placed):
            for x, w in zip(leaves, want):
                if x.device_mesh != self.mesh or list(x.placements) != w:
                    raise ValueError(f"the bank is placed {x.placements} over "
                                     f"{x.device_mesh}, the engine wants {w} over "
                                     f"{self.mesh}")
        elif any(placed):
            raise ValueError("the bank mixes placed and whole leaves")
        else:  # a whole bank: keep the rank's block
            cut = [local_block(x, self.mesh, w).clone() for x, w in zip(leaves, want)]
            self.params = place_chains(tree_unflatten(tree_flatten(self.params)[1], cut),
                                       self.mesh, self.chain_axis, specs)
        self._bank = local(self.params)
        self._local_chains = block.stop - block.start

    def _all_chains(self, per_chain: torch.Tensor) -> torch.Tensor:
        """A step's per-chain block — logits ``(C, B, V)`` on the decode
        engines, predictions ``(C, Q, ...)`` on the predictive one — of
        every chain: placed, the rank's rows all-gathered over the chain
        axis (one collective; a 2-D bank's logits first over ``model``,
        the vocabulary), so every rank runs the identical replicated
        reduce; unplaced, the block itself."""
        if self.mesh is None:
            return per_chain
        if getattr(self, "shard_params", False):
            per_chain = self._model.gather_vocab(per_chain)
        return gather_rows(per_chain, self.mesh, self.chain_axis)

    def _see_rung(self, program: str, rung) -> None:
        """Report ``rung`` of ``program`` to the counters the first time the
        engine meets it: what the JAX package's engines count as a jit
        trace (the port compiles nothing per shape)."""
        if (program, rung) not in self._rungs:
            self._rungs.add((program, rung))
            self._counters.trace(program)

    @property
    def num_traces(self) -> int:
        """Shape rungs met so far, over every program — the JAX engine's
        trace count; a view over the engine's instrument counters."""
        return self._counters.traces

    @property
    def num_host_pad_allocs(self) -> int:
        """Host scratch-buffer creations so far (one per rung, not per
        request); a view over the engine's instrument counters."""
        return self._counters.pad_allocs


def _looks_like_front(x) -> bool:
    """A Model (has .cfg), a config (has .d_model) or a predict fn (a
    function) — never a parameter tree."""
    return hasattr(x, "cfg") or hasattr(x, "d_model") or callable(x)


# ---------------------------------------------------------------------------
# token selection
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche hash on int64 tensors holding values < 2**32
    (odd multipliers below 2**31, so no product leaves int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x6C8E9CF5) & _M32
    return x ^ (x >> 16)


def sample_tokens(logp: torch.Tensor, seeds: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """One token per row of ``logp`` (N, V), drawn from ``softmax(logp)``.

    Gumbel-max with noise that is a pure function of (``seeds[i]`` mod
    2**32, ``positions[i]``, token id): the same seed at the same absolute
    position draws the same token on any device and after any replay."""
    N, V = logp.shape
    dev = logp.device
    row = _mix32(_mix32(seeds.to(dev).long() & _M32)
                 ^ (positions.to(dev).long() & _M32))
    ids = torch.arange(V, device=dev, dtype=torch.int64)
    bits = _mix32(_mix32((row[:, None] + ids[None] * 0x9E3779B1) & _M32))
    u = ((bits >> 8).double() + 0.5) / float(1 << 24)   # (0, 1), exact
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logp.double() + gumbel, dim=-1).to(torch.int32)
