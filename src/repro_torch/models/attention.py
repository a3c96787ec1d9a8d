"""Attention: the naive and the long-prompt prefill paths, and the plain
decode paths (port of ``repro.models.attention``).

:func:`naive_attention` and the decode paths are plain PyTorch with the JAX
package's math: fp32 scores and softmax, a ``-1e30`` mask, the same einsum
orders.  :func:`attention_any` dispatches as the reference does: above
``q_chunk`` (512) query positions, when both lengths divide into chunks, to
:func:`flash_attention`, whose naive scores would otherwise take
``(B, H, S, S)`` fp32 — 34.4 GB a layer for 4 chains of qwen3-4b at 8,192
tokens.  The reference's flash path is a ``lax.scan`` with a hand-written
backward, not a Pallas kernel; the port's is
``torch.nn.functional.scaled_dot_product_attention`` (PyTorch picks the
backend — flash, memory-efficient, cuDNN or math; a bf16 causal prefill
on an H100 ran cuDNN's, and so does a windowed chunk with its mask and
``enable_gqa``) with autograd's backward.  Without a window it is one
causal SDPA call.  With one it goes a query chunk at a time, as the
reference's scan does, over only the key chunks that hold a key the
chunk's queries see — each call with the ``(q_chunk, keys)`` mask of its
own positions, so no ``(Sq, Sk)`` mask is built.  Where the reference
slices (``window_slice``: causal, as many query as key chunks) those are
its in-window chunks; where it does not, its other chunks are masked
whole and add exactly zero, so ``window_slice`` changes the port's
result in nothing and its path not at all.  A
difference by design: in bf16 SDPA's fused kernels feed the tensor cores
bf16 and round the weights to bf16 for ``p . V``, where the reference
computes the chunk in fp32; in fp32 the two agree within 1e-5.

The cached decode step on the serving hot path does not come through here
— it goes through :mod:`repro_torch.kernels.ops`, which launches the CUDA
kernel on a card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _mask_block(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(qc, kc) boolean mask: True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def naive_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).  fp32 softmax.  A chain
    bank flattens its chain axis into B."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, Sq, KV, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bqngh,bcnh->bngqc", qh, k.float())
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = _mask_block(q_pos, k_pos, causal, window)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngqc,bcnh->bqngh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def _key_chunks(q_idx, q_chunk, k_chunk, nk, causal, window):
    """``(lo, hi)``: the key chunks ``lo .. hi - 1`` holding a key that a
    query of chunk ``q_idx`` sees: from the chunk of the first query's
    earliest in-window key to the chunk of the last query's own position
    under ``causal`` (to the last chunk without)."""
    lo = max(0, (q_idx * q_chunk - window + 1) // k_chunk)
    if not causal:
        return lo, nk
    return lo, min(nk, ((q_idx + 1) * q_chunk - 1) // k_chunk + 1)


def flash_attention(q, k, v, causal=True, window=None, q_chunk=512, k_chunk=512,
                    window_slice=False):
    """The long-prompt path: q (B, Sq, H, hd); k, v (B, Sk, KV, hd), H a
    multiple of KV -> (B, Sq, H, hd) in q's dtype.  Positions count from 0
    on both axes, as in the reference's chunks.  Without a window, one SDPA
    call under its own causal mask.  With one, a call a query chunk over
    the key chunks :func:`_key_chunks` gives, each with the
    :func:`_mask_block` of its own positions; the lengths must divide into
    chunks.  ``window_slice`` is the reference's signature: the port reads
    only the in-window chunks either way.  The KV heads are shared through
    ``enable_gqa``, never repeated."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, S, hd)
    if window is None:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)
        return o.transpose(1, 2)
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq % q_chunk or Sk % k_chunk:
        raise ValueError(f"a windowed flash_attention takes lengths that divide into "
                         f"chunks: Sq={Sq} over {q_chunk}, Sk={Sk} over {k_chunk}")
    outs = []
    for i, qb in enumerate(qt.split(q_chunk, dim=2)):
        lo, hi = _key_chunks(i, q_chunk, k_chunk, Sk // k_chunk, causal, window)
        q_pos = torch.arange(i * q_chunk, (i + 1) * q_chunk, device=q.device)
        k_pos = torch.arange(lo * k_chunk, hi * k_chunk, device=q.device)
        keys = slice(lo * k_chunk, hi * k_chunk)
        outs.append(F.scaled_dot_product_attention(
            qb, kt[:, :, keys], vt[:, :, keys],
            attn_mask=_mask_block(q_pos, k_pos, causal, window), enable_gqa=True))
    return torch.cat(outs, dim=2).transpose(1, 2)


def attention_any(q, k, v, *, causal=True, window=None, q_chunk=512,
                  k_chunk=512, window_slice=False):
    """Dispatch as the reference does: :func:`flash_attention` when both
    lengths divide into chunks and there is more than one query chunk,
    else :func:`naive_attention`.  Without a window the chunks decide the
    dispatch only (SDPA tiles on its own)."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq % q_chunk == 0 and Sk % k_chunk == 0 and Sq > q_chunk:
        return flash_attention(q, k, v, causal, window, q_chunk, k_chunk, window_slice)
    return naive_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, cache_pos, cur_pos, *, window=None):
    """One query against a (possibly ring) KV cache, unfused.

    q: (B, 1, H, hd); caches: (B, Smax, KV, hd) with this step's k/v already
    written; cache_pos: (Smax,) or (B, Smax) absolute position of each slot
    (-1 empty); cur_pos: the current absolute position.
    """
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qh = q.reshape(B, KV, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bngh,bcnh->bngc", qh, k_cache.float())
    pos = cache_pos if cache_pos.dim() == 2 else cache_pos[None, :]
    valid = (pos >= 0) & (pos <= cur_pos)
    if window is not None:
        valid &= pos > (cur_pos - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngc,bcnh->bngh", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def paged_decode_attention(q, k_flat, v_flat, tables, positions, page_size):
    """Single-query attention over a paged KV pool, unfused.

    q: (S, 1, H, hd) — one query per slot; k_flat, v_flat:
    (n_pages * page_size, KV, hd) — the shared block pool, flattened, with
    this step's k/v already written; tables: (S, maxp) per-slot page table;
    positions: (S,) absolute position per slot.  Pages are gathered in
    logical order; validity is ``logical index <= position``.
    """
    S, _, H, hd = q.shape
    KV = k_flat.shape[1]
    G = H // KV
    maxp = tables.shape[1]
    qh = q.reshape(S, KV, G, hd).float() / math.sqrt(hd)
    ar = torch.arange(page_size, device=q.device)
    gidx = ((tables.long() * page_size)[:, :, None]
            + ar[None, None]).reshape(S, maxp * page_size)
    kg = k_flat[gidx]                                 # (S, maxp*ps, KV, hd)
    vg = v_flat[gidx]
    s = torch.einsum("bngh,bcnh->bngc", qh, kg.float())
    valid = (torch.arange(maxp * page_size, device=q.device)[None, :]
             <= positions[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngc,bcnh->bngh", p, vg.float())
    return o.reshape(S, 1, H, hd).to(q.dtype)
