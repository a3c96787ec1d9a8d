"""Streaming Bayesian-model-averaged decoding from the chain bank (port of
``repro.cluster.decode``).

A converged bank is C posterior samples of one transformer.
:class:`DecodeEngine` streams multi-token generations whose every token is
drawn from the *Bayesian model average* over the bank: per token, every
chain runs one cached decode step, the per-chain logits are reduced to the
posterior-predictive token law (:func:`~repro_torch.models.predictive.
bma_logits`), and the chosen token feeds back into every chain's cache.

- **KV-cache bank**: one decode cache per batch bucket rung, allocated
  once (``Model.init_cache_bank``) and updated in place across steps.
  Rungs live in an LRU capped at ``max_cache_rungs``.
- **Bucketed prefill**: prompts are padded up the bucket ladder in batch
  and length (numpy scratch, reused per rung); the true prompt length
  rides along, and right padding stays causally invisible.
- **The token loop** is a Python loop over ``Model.serve_step`` (the JAX
  engine's ``lax.scan``); each step launches the decode kernel once per
  layer for all chains and rows, and the tokens stay on the device until
  the generation ends.

``submit()`` / ``drain()`` stack compatible requests (same prompt length,
budget and seed) back into one batch; ``generate()`` is a shim over them.

With ``mesh=`` the bank's chains are split over ``chain_axis``: each
rank's KV-cache bank holds only its chains, and each step's per-chain
logits are all-gathered over the chain axis before the BMA reduce
(:class:`~repro_torch.cluster.api.BankEngine`).  With ``shard_params=True``
each chain's tensors are split over ``model`` too: the cache holds the
rank's KV heads, the decode kernel runs on them, and the logits are
gathered over ``model`` (the vocabulary) first.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.cluster.api import (
    FINISH_LENGTH,
    BankEngine,
    Completion,
    Request,
    sample_tokens,
)
from repro_torch.models.predictive import bma_logits
from repro_torch.models.transformer import Model
from repro_torch.obs.metrics import LATENCY_MS_BUCKETS, registry as _registry
from repro_torch.obs.trace import now as _now, span as _span
from repro_torch.utils import bucket_size, resolve_device

PyTree = Any


class DecodeResult(NamedTuple):
    """One streamed generation: ``tokens`` is ``(B, max_new_tokens)`` int32
    on host; ``logits`` the per-token BMA log-prob block
    ``(B, max_new_tokens, V)`` when ``return_logits``, else ``None``."""

    tokens: np.ndarray
    logits: Optional[np.ndarray]


def _row_seeds(seed: int, rows: int) -> torch.Tensor:
    """One sampling stream per batch row of a request group sharing a seed."""
    return torch.tensor([(seed + r * 0x9E3779B9) & 0xFFFFFFFF
                         for r in range(rows)], dtype=torch.int64)


@dataclass
class DecodeEngine(BankEngine):
    """Streaming multi-token BMA generation over a chain-stacked bank.

    ``model`` is a :class:`~repro_torch.models.transformer.Model` or a
    config; ``params`` the bank ``(C, ...)`` on ``device`` (default
    ``"cuda"``, which needs a card).  ``generate(tokens, n)`` pads the
    prompt batch up the bucket ladder, prefills the rung's persistent
    KV-cache bank, and decodes ``n`` tokens; ``key=None`` decodes greedily,
    an int seed samples from the BMA token law.  ``mesh`` /
    ``chain_axis`` place the bank; ``shard_params=True`` also splits each
    chain's tensors over the mesh's ``model`` axis (a 2-D bank), and each
    rung's KV-cache bank holds the rank's KV heads.
    """

    model: Any
    params: PyTree
    max_seq: int = 256
    buckets: Optional[Sequence[int]] = None         # batch-size ladder
    prompt_buckets: Optional[Sequence[int]] = None  # prompt-length ladder
    return_logits: bool = False
    max_cache_rungs: int = 8
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
        self._model._require_stacked_attention("DecodeEngine")
        self._init_bank()
        self._shard_bank()
        self._cache: OrderedDict = OrderedDict()  # B rung -> KV-cache bank
        reg = _registry()
        self._m_requests = reg.counter("decode.requests", "generate() calls")
        self._m_tokens = reg.counter("decode.tokens",
                                     "tokens generated (true batch rows)")
        self._m_steps = reg.counter(
            "decode.steps", "cached decode steps (one per token after the "
            "first; each launches the decode kernel once per layer)")
        self._m_token_ms = reg.histogram(
            "decode.per_token_ms", LATENCY_MS_BUCKETS,
            "request wall time / max_new_tokens")
        self._m_batch_util = reg.gauge(
            "decode.batch_utilization", "last request's B / batch rung")
        self._m_bank_rungs = reg.gauge(
            "decode.bank_rungs", "KV-cache bank rungs resident")
        self._m_bank_evictions = reg.counter(
            "decode.bank_evictions",
            "KV-cache rungs dropped by the max_cache_rungs LRU cap")

    # -- the token loop -------------------------------------------------------
    def _select(self, logp, seeds, pos: int):
        if seeds is None:
            return torch.argmax(logp, dim=-1).to(torch.int32)
        return sample_tokens(logp, seeds, torch.full_like(seeds, pos))

    @torch.no_grad()
    def _stream(self, cache, tokens, prompt_len: int, max_new: int, seed):
        """Prefill the cache bank, then ``max_new - 1`` cached decode steps.
        Returns device tensors (tokens (B, max_new), logits or None)."""
        model = self._model
        seeds = None if seed is None else _row_seeds(seed, tokens.shape[0])
        last, cache = model.prefill_cache(self._bank, tokens, cache, prompt_len)
        logp = bma_logits(self._all_chains(last))  # (B, V)
        tok = self._select(logp, seeds, prompt_len)
        toks, logps = [tok], [logp]
        pos = prompt_len
        for _ in range(max_new - 1):
            per_chain, cache = model.serve_step(self._bank, cache, tok[:, None], pos)
            logp = bma_logits(self._all_chains(per_chain[:, :, 0]))
            pos += 1
            tok = self._select(logp, seeds, pos)
            toks.append(tok)
            if self.return_logits:
                logps.append(logp)
        self._m_steps.inc(max_new - 1)
        return (torch.stack(toks, dim=1),
                torch.stack(logps, dim=1) if self.return_logits else None)

    # -- KV-cache bank (LRU over batch rungs) ---------------------------------
    def _rung_cache(self, b_rung: int):
        cache = self._cache.pop(b_rung, None)
        if cache is None:
            cache = self._model.init_cache_bank(self._local_chains, b_rung,
                                                self.max_seq)
        return cache

    def _store_rung_cache(self, b_rung: int, cache) -> None:
        # pop-on-read + insert-on-write keeps the OrderedDict in recency
        # order, so the front is always the least-recently-used rung
        self._cache[b_rung] = cache
        while len(self._cache) > self.max_cache_rungs:
            self._cache.popitem(last=False)
            self._m_bank_evictions.inc()
        self._m_bank_rungs.set(float(len(self._cache)))

    # -- request-level endpoint -----------------------------------------------
    def _validate_request(self, request: Request) -> None:
        tokens = np.asarray(request.tokens)
        if tokens.ndim != 1:
            raise ValueError(
                f"a decode Request carries one 1-D prompt, got shape "
                f"{tokens.shape}")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"need max_new_tokens >= 1, got {request.max_new_tokens}")
        t_rung = bucket_size(tokens.shape[0], self.prompt_buckets)
        if not self._model.cfg.sliding_window and \
                t_rung + request.max_new_tokens > self.max_seq:
            # under a sliding window the ring overwriting its oldest slot is
            # exactly the attention semantics; without one it would silently
            # drop real context from every remaining step
            raise ValueError(
                f"prompt rung {t_rung} + max_new_tokens "
                f"{request.max_new_tokens} overflows the {self.max_seq}-slot "
                "cache of a full-attention model; raise max_seq")
        request.tokens = tokens

    def _drain(self, requests):
        """Stack compatible pending prompts — same length, same budget, same
        seed — into batched :meth:`_generate_batch` calls (in first-
        submission order) and hand every request its row back."""
        groups: OrderedDict = OrderedDict()
        for r in requests:
            sig = (r.tokens.shape[0], int(r.max_new_tokens), r.key)
            groups.setdefault(sig, []).append(r)
        out = {}
        for (_, max_new, key), rows in groups.items():
            batch = np.stack([r.tokens for r in rows])
            res = self._generate_batch(batch, max_new, key)
            t_done = _now()
            for i, r in enumerate(rows):
                # batch engines deliver whole generations at drain: the
                # first token becomes host-visible when the batch does
                r.timing["first_token"] = r.timing["finished"] = t_done
                out[r.request_id] = Completion(
                    request_id=r.request_id, tokens=res.tokens[i],
                    logits=(res.logits[i] if res.logits is not None
                            else None),
                    finish_reason=FINISH_LENGTH, timing=r.timing)
        return [out[r.request_id] for r in requests]

    # -- serving --------------------------------------------------------------
    def _generate_batch(self, tokens: np.ndarray, max_new_tokens: int,
                        key: Optional[int]) -> DecodeResult:
        """Pad one (B, T) prompt batch up its rung pair, prefill the rung's
        cache bank, run the token loop, trim on host."""
        B, T = tokens.shape
        b_rung = bucket_size(B, self.buckets)
        t_rung = bucket_size(T, self.prompt_buckets)
        self._see_rung("decode", (b_rung, t_rung, int(max_new_tokens), key is None))
        t_start = _now()
        with _span("decode.generate", B=B, T=T, b_rung=b_rung, t_rung=t_rung,
                   new_tokens=int(max_new_tokens), chains=self.num_chains):
            buf = self._scratch.get(("prompt", b_rung, t_rung),
                                    (b_rung, t_rung), np.int32)
            buf[:B, :T] = tokens
            buf[:B, T:] = tokens[:, -1:]  # right pad: causally invisible
            buf[B:] = buf[B - 1]          # edge-replicate padded batch rows
            cache = self._rung_cache(b_rung)
            toks, logps = self._stream(cache, torch.from_numpy(buf), T,
                                       int(max_new_tokens), key)
            self._store_rung_cache(b_rung, cache)  # updated in place, reused
            out = toks.cpu().numpy()[:B]  # waits: the span sees real latency
        self._m_requests.inc()
        self._m_tokens.inc(B * int(max_new_tokens))
        self._m_token_ms.observe((_now() - t_start) * 1e3 / max_new_tokens)
        self._m_batch_util.set(B / b_rung)
        return DecodeResult(
            tokens=out,
            logits=logps.cpu().numpy()[:B] if self.return_logits else None)

    def generate(self, tokens, max_new_tokens: int,
                 key: Optional[int] = None) -> DecodeResult:
        """Stream ``max_new_tokens`` BMA tokens from a ``(B, T)`` prompt
        batch: greedy when ``key`` is None, else sampled from the BMA law
        with the int seed ``key``.  Returns host arrays trimmed to the true
        batch."""
        tokens = np.asarray(tokens)
        if tokens.ndim != 2:
            raise ValueError(f"prompt batch must be (B, T), got {tokens.shape}")
        ids = [self.submit(Request(tokens=row,
                                   max_new_tokens=int(max_new_tokens),
                                   key=key))
               for row in tokens]
        by_id = {c.request_id: c for c in self.drain()}
        rows = [by_id[i] for i in ids]
        return DecodeResult(
            tokens=np.stack([c.tokens for c in rows]),
            logits=(np.stack([c.logits for c in rows])
                    if self.return_logits else None))

    __call__ = generate
