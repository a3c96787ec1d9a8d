"""Plain PyTorch versions of the port's kernels (port of
``repro.kernels.ref``): the two decode steps, the Langevin update, the
W-Icon delay gather, the coordinate-delay draw, and the one-pass W-Icon
read (the draw, then the gather).

Decode steps:
The same math and op order as the JAX oracles: the new row selected in at
its position, ``q * (1/sqrt(hd))`` in fp32, fp32 scores, a ``-1e30`` mask,
``p = exp(s - max); p = p / sum(p)``, ``p . V`` in fp32, the output cast to
q's dtype.  Like the CUDA kernels they replace on the card, they update the
caches **in place** (what ``input_output_aliases`` does in the JAX
package) and return ``(o, k_cache, v_cache)`` with the same cache objects.
The CPU path of :mod:`repro_torch.kernels.ops` runs them, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import rng

NEG_INF = -1e30
_RAW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _softmax_pv(s, v):
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("...ngc,...cnh->...ngh", p, v.float())


def decode_step_ref(q, k_new, v_new, k_cache, v_cache, valid, slot: int):
    """Ring-cache decode step.

    q: (N, KV, G, hd); k_new/v_new: (N, KV, hd); caches: (N, smax, KV, hd)
    (a chain bank flattens chains x rows into N); valid: (smax,) int32
    (1 = attend); slot: the ring slot the new row lands in.
    """
    hd = k_cache.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    k_cache[:, slot] = k_new
    v_cache[:, slot] = v_new
    q32 = q.float() * scale
    s = torch.einsum("bngh,bcnh->bngc", q32, k_cache.float())
    s = torch.where(valid[None, None, None, :] == 1, s, NEG_INF)
    o = _softmax_pv(s, v_cache)
    return o.to(q.dtype), k_cache, v_cache


def paged_decode_step_ref(q, k_new, v_new, k_pages, v_pages, tables, pos):
    """Paged decode step over one shared page pool per chain.

    q: (C, S, KV, G, hd); k_new/v_new: (C, S, KV, hd); k_pages/v_pages:
    (C, n_pages, page_size, KV, hd); tables: (S, maxp) int32, shared by the
    chains; pos: (S,) int32.  Each slot's pages are gathered in logical
    order from the pool as it was before this step, the new row is
    overlaid at logical ``pos`` (so slots that share the garbage row each
    see their own), and the rows ``(tables[s, pos // ps], pos % ps)`` are
    stored last.
    """
    C, S, KV, G, hd = q.shape
    ps = k_pages.shape[2]
    maxp = tables.shape[1]
    scale = 1.0 / math.sqrt(hd)
    kf = k_pages.view(C, -1, KV, hd)
    vf = v_pages.view(C, -1, KV, hd)
    tables = tables.long()
    pos = pos.long()
    ar = torch.arange(maxp * ps, device=q.device)
    gidx = ((tables * ps)[:, :, None]
            + torch.arange(ps, device=q.device)[None, None]).reshape(S, maxp * ps)
    sel = (ar[None, :, None, None] == pos[:, None, None, None])[None]
    k = torch.where(sel, k_new[:, :, None], kf[:, gidx])   # (C, S, maxp*ps, KV, hd)
    v = torch.where(sel, v_new[:, :, None], vf[:, gidx])
    q32 = q.float() * scale
    s = torch.einsum("...ngh,...cnh->...ngc", q32, k.float())
    valid = ar[None, :] <= pos[:, None]
    s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
    o = _softmax_pv(s, v)
    widx = tables[torch.arange(S, device=q.device), pos // ps] * ps + pos % ps
    kf[:, widx] = k_new
    vf[:, widx] = v_new
    return o.to(q.dtype), k_pages, v_pages


def langevin_update_ref(x, g, seed, gamma, scale):
    """The fused SGLD commit ``x <- x - gamma*g + scale*xi``, **in place**
    on ``x``, with ``xi`` the threefry/Box-Muller normal of each element's
    flat index under ``seed`` (a ``(s0, s1)`` pair).

    x, g: any shape, bfloat16 or float32, same numel; gamma, scale: float32
    scalars.  Each element is read in its dtype and updated in float32 as
    ``fma(scale, xi, fma(-gamma, g, x))`` — the order in which the JAX
    reference evaluates ``x - gamma*g + scale*xi`` (XLA contracts both
    products into fused multiply-adds) and the CUDA kernel's.  A float32
    fma is emulated in float64: the product is exact there and the sum
    rounds twice, which differs from one rounding with probability about
    2^-29 per element.  The result is written back in x's dtype.  Works in
    slices of ``rng.CHUNK`` elements.  Returns x."""
    xf, gf = x.view(-1), g.reshape(-1)
    gamma = float(torch.tensor(gamma, dtype=torch.float32))
    scale = float(torch.tensor(scale, dtype=torch.float32))
    for a in range(0, xf.numel(), rng.CHUNK):
        b = min(xf.numel(), a + rng.CHUNK)
        xi = rng.normal(seed, a, b, x.device).double()
        t = (xf[a:b].double() - gamma * gf[a:b].double()).float()
        xf[a:b] = (t.double() + scale * xi).float().to(x.dtype)
    return x


def delay_gather_ref(history, delays, head: int):
    """W-Icon read ``out[i] = history[(head - delays[i]) mod depth, i]``.

    history: (depth, N) of any dtype; delays: (N,) int32; head: the ring
    slot of the newest snapshot.  A true gather: the selected element is
    copied, ``-0.0``, ``inf`` and ``nan`` included (the JAX Pallas kernel
    selects by multiply-and-sum, which turns a selected ``-0.0`` into
    ``+0.0``).  It gathers the raw bits, through an integer view of the
    same width: ATen's CPU gather of bfloat16 rewrites a NaN's bits."""
    slots = torch.remainder(int(head) - delays.long(), history.shape[0])
    raw = _RAW[history.element_size()]
    return torch.gather(history.view(raw), 0, slots[None])[0].view(history.dtype)


def coordinate_delays_ref(key, n: int, maxval: int, device="cpu"):
    """Per-coordinate delays ``U{0..maxval-1}`` as int32, bit for bit
    ``jax.random.randint(key, (n,), 0, maxval, int32)``."""
    return rng.randint(key, n, maxval, device)


def wicon_read_ref(history, key, maxval: int, head: int):
    """The one-pass W-Icon read: the delays of :func:`coordinate_delays_ref`
    gathered by :func:`delay_gather_ref`.  history: (depth, N)."""
    n = history.shape[1]
    return delay_gather_ref(history, coordinate_delays_ref(key, n, maxval,
                                                           history.device), head)
