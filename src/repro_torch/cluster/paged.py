"""Continuous batching over a paged KV bank — slot-level BMA serving (port
of ``repro.cluster.paged``).

The bank's KV state is **one shared block pool per chain**
(:meth:`Model.init_paged_bank` — ``(L, C, n_pages, page_size, KV, hd)``)
and every serving slot maps its logical context into that pool through a
per-slot **page table**, so

- sequences of different lengths share device memory with no per-request
  reallocation (a slot holds pages, not a ``max_seq`` ring);
- a waiting prompt is prefilled **the moment any sequence finishes or is
  evicted** — admission is per slot, not per batch;
- inactive slots keep stepping against the reserved **garbage page**
  (physical page 0) with their positions clamped to 0, so slot churn never
  changes a shape.

Scheduling.  ``submit()`` enqueues :class:`~repro_torch.cluster.api.
Request`\\ s; ``step()`` admits waiting requests into free slots (highest
priority first, FIFO within a priority), runs up to ``decode_chunk``
micro-steps over all slots — each one launch of the paged decode kernel per
layer for every chain and slot — and completes whatever finished.  When
every slot is busy and a strictly-higher-priority request waits, the
lowest-priority active slot is **preempted**: its pages are freed, its
tokens discarded, and its request requeued; replay is identical because
a sampled token is drawn under ``fold_in(key, absolute position)``, as in
the reference: the prefill's first token under ``fold_in(key,
prompt_len)``, a micro-step's under ``fold_in(key_s, pos + 1)`` for each
sampling slot (:func:`~repro_torch.kernels.rng.fold_in_rows`, then
:func:`~repro_torch.kernels.rng.categorical_rows`: ``vmap(jax.random.
categorical)``, bit for bit).  So the same key and bank give the JAX
package's tokens, and a chunk with no sampling slot draws nothing.
Requests past ``deadline_ms`` are shed while waiting or cut short in their
slot, and ``max_waiting`` bounds the waiting queue.

With ``mesh=`` the page pool's chain axis is placed as the bank's: each
rank's pool holds only its chains, and each micro-step's per-chain logits
are all-gathered over the chain axis before the BMA reduce.  The
allocator, the page tables and the scheduler are the same on every rank;
deadlines are judged on the mesh's first rank and broadcast, so every
rank sheds and cuts the same requests.  With ``shard_params=True`` each
chain's tensors are split over ``model`` too: the pool holds the rank's KV
heads and the paged kernel runs on them; the page tables, admission and
preemption stay replicated, decided on every rank from the same requests
and the same gathered tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.api import (
    FINISH_DEADLINE,
    FINISH_LENGTH,
    STATUS_OK,
    STATUS_SHED,
    STATUS_TIMEOUT,
    BankEngine,
    Completion,
    Request,
)
from repro_torch.kernels import rng
from repro_torch.models.predictive import bma_logits
from repro_torch.models.transformer import Model
from repro_torch.obs.metrics import LATENCY_MS_BUCKETS, registry as _registry
from repro_torch.obs.trace import now as _now, span as _span, tracer as _tracer
from repro_torch.utils import bucket_size, broadcast_from_origin, cdiv, resolve_device

PyTree = Any


class PageAllocator:
    """Free-list allocator over the physical pages of a paged KV pool.

    Page 0 is reserved as the garbage page inactive slots write into and is
    never handed out.  ``alloc(n)`` returns ``n`` page ids or ``None`` if
    the pool can't cover them (no partial allocation); ``free(pages)``
    returns them.  The scheduler sizes the pool so a free *slot* always
    implies enough free pages (``num_slots * pages_per_slot + 1``).
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (garbage + 1), got {num_pages}")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> ascending

    @property
    def free_pages(self) -> int:
        """Pages currently available (garbage page excluded)."""
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` physical page ids, or ``None`` if fewer than ``n`` free."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        """Return page ids to the pool (garbage page 0 is rejected)."""
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"bad page id {p}")
        self._free.extend(pages)


@dataclass
class _Active:
    """Host-side bookkeeping for one occupied serving slot."""

    request: Request
    pages: List[int]
    tokens: List[int]
    logits: List[np.ndarray]
    seq: int  # admission sequence number (evict ties: youngest goes)


@dataclass
class PagedDecodeEngine(BankEngine):
    """Continuously-batched BMA generation over a paged KV bank.

    ``model`` / ``params`` / ``device`` are as in :class:`~repro_torch.
    cluster.decode.DecodeEngine` (full-attention stacks only).
    ``num_slots`` sequences decode concurrently; each may hold up to
    ``max_seq / page_size`` pages.  ``step()`` pumps the scheduler once;
    ``submit()`` / ``drain()`` are the request-level surface.  A request
    with ``key=None`` decodes greedily, a PRNG key (or an int seed of
    one) samples from the BMA law.  ``mesh`` / ``chain_axis`` place the
    bank and the pool; ``shard_params=True`` also splits each chain's tensors over the mesh's
    ``model`` axis (a 2-D bank), and the pool holds the rank's KV heads.
    """

    model: Any
    params: PyTree
    num_slots: int = 8
    page_size: int = 16
    max_seq: int = 256
    decode_chunk: int = 8
    prompt_buckets: Optional[Sequence[int]] = None  # prompt-length ladder
    return_logits: bool = False
    max_waiting: Optional[int] = None  # submit() backpressure bound
    device: Any = "cuda"
    mesh: Any = None
    chain_axis: str = "data"
    shard_params: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        cfg = self.model.cfg if hasattr(self.model, "cfg") else self.model
        self._model = Model(cfg, device=self.device,
                            mesh=self.mesh if self.shard_params else None,
                            chain_axis=self.chain_axis if self.shard_params else None)
        self._model._require_paged("PagedDecodeEngine")
        self._init_bank()
        self._shard_bank()
        if self.max_seq % self.page_size:
            raise ValueError(
                f"max_seq={self.max_seq} must be a multiple of "
                f"page_size={self.page_size}")
        if self.decode_chunk < 1 or self.num_slots < 1:
            raise ValueError("need decode_chunk >= 1 and num_slots >= 1")
        self.pages_per_slot = self.max_seq // self.page_size
        self.num_pages = self.num_slots * self.pages_per_slot + 1
        self._allocator = PageAllocator(self.num_pages)
        self._pages = self._model.init_paged_bank(
            self._local_chains, self.num_pages, self.page_size)
        S = self.num_slots
        self._tables = np.zeros((S, self.pages_per_slot), np.int32)
        self._positions = np.zeros((S,), np.int32)
        self._remaining = np.zeros((S,), np.int32)
        self._last_tok = np.zeros((S,), np.int32)
        self._keys = np.zeros((S, 2), np.int64)
        self._greedy = np.ones((S,), bool)
        self._slots: List[Optional[_Active]] = [None] * S
        self._waiting: List[Request] = []
        self._seq = 0
        reg = _registry()
        self._m_requests = reg.counter("paged.requests", "requests completed")
        self._m_tokens = reg.counter("paged.tokens", "tokens generated")
        self._m_micro = reg.counter(
            "paged.micro_steps", "decode micro-steps over all slots (each "
            "launches the paged kernel once per layer)")
        self._m_admissions = reg.counter("paged.admissions",
                                         "slot admissions (prefills)")
        self._m_evictions = reg.counter(
            "paged.evictions", "priority preemptions (request requeued)")
        self._m_occupancy = reg.gauge("paged.slot_occupancy",
                                      "active slots / num_slots")
        self._m_pages = reg.gauge(
            "paged.page_utilization",
            "allocated pages / pool (garbage page excluded)")
        self._m_ttft = reg.histogram(
            "paged.ttft_ms", LATENCY_MS_BUCKETS,
            "submit -> first token on host (emitted at admission prefill)")
        self._m_shed = reg.counter(
            "requests.shed", "requests dropped un-admitted: deadline expired "
            "while waiting")
        self._m_timeout = reg.counter(
            "requests.timeout",
            "requests cut short mid-decode: deadline expired in a slot")

    # -- device work ----------------------------------------------------------
    @torch.no_grad()
    def _prefill(self, tokens, table, prompt_len: int, key):
        """Prefill one prompt into its slot's pages; returns the first
        token (host int; drawn under ``fold_in(key, prompt_len)``, greedy
        when ``key`` is None) and its BMA log-probs (device, (V,))."""
        last, self._pages = self._model.paged_prefill(
            self._bank, torch.from_numpy(tokens), self._pages, table, prompt_len)
        logp = bma_logits(self._all_chains(last))[0]  # (C, 1, V) -> (V,)
        if key is None:
            tok = torch.argmax(logp)
        else:
            tok = rng.categorical(rng.fold_in(key, prompt_len), logp)
        return int(tok), logp

    @torch.no_grad()
    def _decode_chunk(self):
        """Up to ``decode_chunk`` micro-steps over every slot.  Returns
        host tokens ``(steps, S)`` (-1 where a slot was inactive) and the
        BMA log-probs ``(steps, S, V)`` when ``return_logits``."""
        dev = self.device
        self._see_rung("paged_step", ())  # slot churn never changes a shape
        tables = torch.from_numpy(self._tables).to(dev)
        sampling = np.flatnonzero(~self._greedy)  # the host knows: none, no draw
        if sampling.size:
            rows = torch.from_numpy(sampling).to(dev)
            # a sampling slot's key at micro-step t: fold_in(key, pos + 1) at
            # its position pos + t while active (an inactive slot's token is
            # dropped), every step's at once: one copy to the device a chunk
            t = np.arange(self.decode_chunk)[:, None]
            keys = rng.fold_in_rows(
                np.broadcast_to(self._keys[sampling], (t.size, sampling.size, 2)),
                (self._positions[sampling] + t + 1).ravel(),
            ).reshape(t.size, sampling.size, 2).to(dev)
        last_tok = torch.from_numpy(self._last_tok).to(dev)
        positions = self._positions.copy()
        remaining = self._remaining.copy()
        toks, logps = [], []
        for step in range(self.decode_chunk):
            active = remaining > 0
            if not active.any():
                break
            # inactive slots write position 0 of their zeroed table row: the
            # garbage page — real pages are never touched
            pos = np.where(active, positions, 0).astype(np.int32)
            pos_t = torch.from_numpy(pos).to(dev)
            per_chain, self._pages = self._model.paged_step(
                self._bank, self._pages, tables, last_tok[:, None], pos_t)
            logp = bma_logits(self._all_chains(per_chain[:, :, 0]))  # (S, V)
            nxt = torch.argmax(logp, dim=-1).to(torch.int32)
            if sampling.size:
                nxt[rows] = rng.categorical_rows(keys[step], logp[rows]).to(torch.int32)
            act = torch.from_numpy(active).to(dev)
            nxt = torch.where(act, nxt, last_tok)
            toks.append(torch.where(act, nxt, -1))
            if self.return_logits:
                logps.append(logp)
            positions = np.where(active, positions + 1, positions)
            remaining = remaining - active
            last_tok = nxt
        self._m_micro.inc(len(toks))
        return (torch.stack(toks).cpu().numpy(),
                torch.stack(logps).cpu().numpy() if self.return_logits else None)

    # -- request validation / queueing ----------------------------------------
    def _validate_request(self, request: Request) -> None:
        tokens = np.asarray(request.tokens)
        if tokens.ndim != 1:
            raise ValueError(
                f"a paged Request carries one 1-D prompt, got {tokens.shape}")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"need max_new_tokens >= 1, got {request.max_new_tokens}")
        t_rung = bucket_size(tokens.shape[0], self.prompt_buckets)
        need = max(t_rung, tokens.shape[0] + request.max_new_tokens)
        if need > self.max_seq:
            raise ValueError(
                f"prompt rung {t_rung} + max_new_tokens "
                f"{request.max_new_tokens} overflows the {self.max_seq}-token "
                "slot capacity (num pages x page size); raise max_seq")
        request.tokens = tokens

    def _enqueue(self, requests: Sequence[Request]) -> None:
        for r in requests:
            if not hasattr(r, "_seq"):  # preserved across eviction requeues
                r._seq = self._seq
                self._seq += 1
        self._waiting.extend(requests)
        self._waiting.sort(key=lambda r: (-r.priority, r._seq))

    def _queue_depth(self) -> int:
        # max_waiting counts the whole backlog: unpumped + scheduler queue
        return len(self._pending) + len(self._waiting)

    # -- deadlines: shed the waiting, cut short the decoding -------------------
    @staticmethod
    def _expired(req: Request, now: float) -> bool:
        if req.deadline_ms is None:
            return False
        return now >= req.timing["submitted"] + req.deadline_ms * 1e-3

    def _deadline_hits(self, reqs: Sequence[Request]) -> List[bool]:
        """Which of ``reqs`` are past their deadline now.  Placed, the
        mesh's origin rank decides and broadcasts over the mesh (one
        broadcast a mesh dimension, only while some request carries a
        deadline): the ranks' clocks and submission times differ, and
        their schedules must not."""
        if all(r.deadline_ms is None for r in reqs):
            return [False] * len(reqs)
        now = _now()
        hits = [self._expired(r, now) for r in reqs]
        if self.mesh is None:
            return hits
        t = torch.tensor(hits, dtype=torch.uint8, device=self.mesh.device_type)
        return [bool(v) for v in broadcast_from_origin(t, self.mesh).tolist()]

    def _shed_one(self, req: Request) -> Completion:
        req.timing["finished"] = _now()
        _tracer().record("paged.shed", req.timing["submitted"],
                         req.timing["finished"], request_id=req.request_id,
                         deadline_ms=req.deadline_ms)
        self._m_shed.inc()
        return Completion(
            request_id=req.request_id, tokens=np.zeros((0,), np.int32),
            logits=None, finish_reason=FINISH_DEADLINE, timing=req.timing,
            status=STATUS_SHED)

    def _shed_waiting(self, finished: List[Completion]) -> None:
        hits = self._deadline_hits(self._waiting)
        expired = [r for r, h in zip(self._waiting, hits) if h]
        if expired:
            self._waiting = [r for r, h in zip(self._waiting, hits) if not h]
            finished.extend(self._shed_one(r) for r in expired)

    def _expire_active(self, finished: List[Completion]) -> None:
        slots = [s for s, a in enumerate(self._slots) if a is not None]
        hits = self._deadline_hits([self._slots[s].request for s in slots])
        for s, hit in zip(slots, hits):
            if hit:
                self._m_timeout.inc()
                finished.append(self._finish(s, status=STATUS_TIMEOUT,
                                             reason=FINISH_DEADLINE))

    # -- scheduler: admission / eviction / completion --------------------------
    def _free_slot(self) -> Optional[int]:
        for s, a in enumerate(self._slots):
            if a is None:
                return s
        return None

    def _evict(self, s: int) -> None:
        """Preempt slot ``s``: free its pages, discard its tokens, requeue
        its request (position-folded keys make the replay identical)."""
        victim = self._slots[s]
        self._allocator.free(victim.pages)
        self._tables[s] = 0
        self._remaining[s] = 0
        self._slots[s] = None
        victim.request.timing["evictions"] = \
            victim.request.timing.get("evictions", 0) + 1
        self._m_evictions.inc()
        self._enqueue([victim.request])

    def _admit(self, finished: List[Completion]) -> None:
        while self._waiting:
            req = self._waiting[0]
            if self._deadline_hits([req])[0]:  # never prefill a dead request
                self._waiting.pop(0)
                finished.append(self._shed_one(req))
                continue
            s = self._free_slot()
            if s is None:
                active = [i for i, a in enumerate(self._slots)
                          if a is not None]
                victim = min(active, key=lambda i: (
                    self._slots[i].request.priority, -self._slots[i].seq))
                if self._slots[victim].request.priority >= req.priority:
                    return  # nothing strictly lower-priority to preempt
                self._evict(victim)
                continue
            self._waiting.pop(0)
            done = self._admit_one(s, req)
            if done is not None:  # max_new_tokens == 1: finished at prefill
                finished.append(done)

    def _admit_one(self, s: int, req: Request) -> Optional[Completion]:
        T = int(req.tokens.shape[0])
        t_rung = bucket_size(T, self.prompt_buckets)
        self._see_rung("paged_prefill", t_rung)
        n_pages = cdiv(max(t_rung, T + req.max_new_tokens), self.page_size)
        pages = self._allocator.alloc(n_pages)
        if pages is None:
            raise RuntimeError("free slot without free pages (pool sizing bug)")
        t0 = _now()
        self._tables[s] = 0
        self._tables[s, :n_pages] = pages
        buf = self._scratch.get(("prompt", t_rung), (1, t_rung), np.int32)
        buf[0, :T] = req.tokens
        buf[0, T:] = req.tokens[-1]  # right pad: causally invisible
        tok0, logp0 = self._prefill(buf, self._tables[s], T, req.key)
        t1 = _now()
        req.timing.setdefault("admitted", t1)
        req.timing["first_token"] = t1  # TTFT: emitted at admission
        self._m_admissions.inc()
        self._m_ttft.observe((t1 - req.timing["submitted"]) * 1e3)
        _tracer().record("paged.admit", t0, t1, slot=s,
                         request_id=req.request_id, T=T, t_rung=t_rung,
                         pages=n_pages)
        active = _Active(request=req, pages=pages, tokens=[tok0],
                         logits=([logp0.cpu().numpy()] if self.return_logits
                                 else []), seq=self._seq)
        self._seq += 1
        self._slots[s] = active
        if req.max_new_tokens == 1:
            return self._finish(s)
        self._positions[s] = T       # tok0 is written here next micro-step
        self._remaining[s] = req.max_new_tokens - 1
        self._last_tok[s] = tok0
        self._keys[s] = (0, 0) if req.key is None else req.key
        self._greedy[s] = req.key is None
        self._gauges()
        return None

    def _finish(self, s: int, *, status: str = STATUS_OK,
                reason: str = FINISH_LENGTH) -> Completion:
        a = self._slots[s]
        self._allocator.free(a.pages)
        self._tables[s] = 0
        self._remaining[s] = 0
        self._slots[s] = None
        r = a.request
        r.timing["finished"] = _now()
        _tracer().record("paged.request", r.timing["submitted"],
                         r.timing["finished"], slot=s,
                         request_id=r.request_id,
                         new_tokens=len(a.tokens),
                         evictions=r.timing.get("evictions", 0),
                         status=status)
        self._m_requests.inc()
        self._m_tokens.inc(len(a.tokens))
        self._gauges()
        return Completion(
            request_id=r.request_id,
            tokens=np.asarray(a.tokens, np.int32),
            logits=(np.stack(a.logits) if self.return_logits else None),
            finish_reason=reason, timing=r.timing, status=status)

    def _gauges(self) -> None:
        used = sum(a is not None for a in self._slots)
        self._m_occupancy.set(used / self.num_slots)
        self._m_pages.set(
            1.0 - self._allocator.free_pages / (self.num_pages - 1))

    @property
    def num_active(self) -> int:
        """Slots currently decoding a sequence."""
        return sum(a is not None for a in self._slots)

    @property
    def num_waiting(self) -> int:
        """Requests admitted to the scheduler but not yet in a slot."""
        return len(self._waiting)

    @property
    def free_pages(self) -> int:
        """Pages of the pool not held by any slot (garbage page excluded)."""
        return self._allocator.free_pages

    # -- the pump --------------------------------------------------------------
    def step(self) -> List[Completion]:
        """One scheduler pump: admit waiting requests into free slots, run
        one micro-batch of up to ``decode_chunk`` tokens over every slot,
        and return whatever finished (freed slots are refilled at once).
        Requests past their ``deadline_ms`` are shed from the waiting queue
        (and cut short in their slots) before any device work is spent on
        them."""
        self._enqueue(self._pending)
        self._pending = []
        finished: List[Completion] = []
        self._shed_waiting(finished)
        self._expire_active(finished)
        self._admit(finished)
        if self.num_active:
            with _span("paged.decode_chunk", active=self.num_active,
                       chunk=self.decode_chunk):
                toks, logps = self._decode_chunk()  # host: waits for the card
            for s, a in enumerate(self._slots):
                if a is None:
                    continue
                n = min(self.decode_chunk, int(self._remaining[s]))
                a.tokens.extend(int(t) for t in toks[:n, s])
                if self.return_logits:
                    a.logits.extend(logps[t, s] for t in range(n))
                self._positions[s] += n
                self._remaining[s] -= n
                self._last_tok[s] = toks[n - 1, s]
                if self._remaining[s] == 0:
                    finished.append(self._finish(s))
            self._expire_active(finished)  # partial prefix beats a dead slot
        self._admit(finished)  # admission the moment a sequence finishes
        return finished

    def _drain(self, requests: Sequence[Request]) -> List[Completion]:
        self._enqueue(list(requests))
        done = {}
        while self._waiting or self.num_active:
            for c in self.step():
                done[c.request_id] = c
        ordered = [done.pop(r.request_id) for r in requests
                   if r.request_id in done]
        return ordered + list(done.values())
