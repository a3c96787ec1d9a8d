"""Plain PyTorch versions of the port's kernels (port of
``repro.kernels.ref``): the two decode steps, the Langevin update, the
W-Icon delay gather, the coordinate-delay draw, and the one-pass W-Icon
read (the draw, then the gather).  The last four take C chains on a
leading axis, as the kernels do (C = 1 for a single chain), and run chain
by chain: chain c is what ``jax.vmap`` of the JAX package's kernel
computes for it.

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


def _update_row(x, g, seed, gamma, scale, check: bool = False) -> bool:
    """One chain's update in place; with ``check``, True when an updated
    element is NaN or Inf (after the cast to x's dtype)."""
    xf, gf = x.view(-1), g.reshape(-1)
    gamma = float(torch.tensor(gamma, dtype=torch.float32))
    scale = float(torch.tensor(scale, dtype=torch.float32))
    bad = False
    for a in range(0, xf.numel(), rng.CHUNK):
        b = min(xf.numel(), a + rng.CHUNK)
        xi = rng.normal(seed, a, b, x.device).double()
        t = (xf[a:b].double() - gamma * gf[a:b].double()).float()
        xf[a:b] = (t.double() + scale * xi).float().to(x.dtype)
        if check and not bad:
            bad = not bool(torch.isfinite(xf[a:b]).all())
    return bad


def langevin_update_ref(x, g, seeds, gammas, scales, skip=None, flags=None):
    """The fused SGLD commit ``x[c] <- x[c] - gamma_c*g[c] + scale_c*xi_c``
    of every chain of ``x`` / ``g`` ``(C, ...)``, **in place** on ``x``,
    with ``xi_c`` the threefry/Box-Muller normal of each element's index
    within its chain under ``seeds[c]`` (a ``(s0, s1)`` pair).

    x, g: bfloat16 or float32, same shape; gammas, scales: C float32
    values.  Each element is read in its dtype and updated in float32 as
    ``fma(scale, xi, fma(-gamma, g, x))`` — the order in which the JAX
    reference evaluates ``x - gamma*g + scale*xi`` (XLA contracts both
    products into fused multiply-adds) and the CUDA kernel's.  A float32
    fma is emulated in float64: the product is exact there and the sum
    rounds twice, which differs from one rounding with probability about
    2^-29 per element.  The result is written back in x's dtype.  Works in
    slices of ``rng.CHUNK`` elements.

    ``skip`` (C host bools, optional): a skipped chain's row is neither
    read nor written (its gradient row may hold anything).  ``flags``
    (optional ``(C,)`` int32): set to 1 for a chain any of whose updated
    elements is NaN or Inf, left alone otherwise.  Returns x."""
    for c in range(x.shape[0]):
        if skip is not None and skip[c]:
            continue
        if _update_row(x[c], g[c], seeds[c], gammas[c], scales[c], flags is not None):
            flags[c] = 1
    return x


def _gather_row(history, delays, head: int):
    slots = torch.remainder(int(head) - delays.long(), history.shape[0])
    raw = _RAW[history.element_size()]
    return torch.gather(history.view(raw), 0, slots[None])[0].view(history.dtype)


def delay_gather_ref(history, delays, heads):
    """W-Icon read ``out[c, i] = history[c, (heads[c] - delays[c, i]) mod
    depth, i]``.

    history: (C, depth, N) of any dtype; delays: (C, N) int32; heads: C
    ints, chain c's ring slot of its newest snapshot.  A true gather: the
    selected element is copied, ``-0.0``, ``inf`` and ``nan`` included
    (the JAX Pallas kernel selects by multiply-and-sum, which turns a
    selected ``-0.0`` into ``+0.0``).  It gathers the raw bits, through an
    integer view of the same width: ATen's CPU gather of bfloat16 rewrites
    a NaN's bits."""
    return torch.stack([_gather_row(history[c], delays[c], heads[c])
                        for c in range(history.shape[0])])


def coordinate_delays_ref(keys, n: int, maxvals, device="cpu"):
    """Per-coordinate delays of C chains, ``(C, n)`` int32: row c is
    ``jax.random.randint(keys[c], (n,), 0, maxvals[c], int32)`` bit for
    bit."""
    return torch.stack([rng.randint(k, n, m, device) for k, m in zip(keys, maxvals)])


def wicon_read_ref(history, keys, maxvals, heads):
    """The one-pass W-Icon read: the delays of :func:`coordinate_delays_ref`
    gathered by :func:`delay_gather_ref`, chain c from its head
    ``heads[c]``.  history: (C, depth, N) -> (C, N)."""
    n, dev = history.shape[2], history.device
    return torch.stack([_gather_row(history[c], rng.randint(k, n, m, dev), heads[c])
                        for c, (k, m) in enumerate(zip(keys, maxvals))])
