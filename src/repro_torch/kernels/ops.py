"""The kernels in model layout (port of ``repro.kernels.ops``): the two
decode steps, the fused Langevin update over a parameter tree, the W-Icon
delay draw and gather, and the one-pass W-Icon read that draws and
gathers in one launch.  The last four take C chains stacked on a leading
axis (C = 1 for a single chain; what ``jax.vmap`` of the JAX package's ops
computes) in one launch a leaf for every chain.

Dispatch goes by the tensors' device, and nothing else: on a CUDA tensor
the op **is** the hand-written kernel (:mod:`~repro_torch.kernels.
decode_step`, :mod:`~repro_torch.kernels.langevin_update`,
:mod:`~repro_torch.kernels.delay_gather`), which launches or raises —
there is no fallback; on a CPU tensor it is the plain version
(:mod:`repro_torch.kernels.ref`).  Either way caches, pools and the
updated parameters change in place.

On a ``meta`` tensor (the dry run, :mod:`repro_torch.launch.dryrun`) an
op returns its outputs' shapes and launches nothing; on ``meta`` and on a
card it reports its work to any open cost count
(:func:`repro_torch.analysis.cost.record_kernel`), from the formulas
``chip_smoke.py`` bounds the kernels with — the kernels are reached
through ``ctypes``, where no dispatch mode sees them.  A device other
than these three raises, and so does a ``DTensor``: an op takes the
local rows a rank holds (:func:`repro_torch.utils.local`), because the
kernels, bound through ``ctypes``, would read the wrapper's storage and
DTensor dispatch would otherwise fail in the binding or gather the whole
tensor onto every rank.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import decode_step as ds
from repro_torch.kernels import delay_gather as dg
from repro_torch.kernels import langevin_update as lu
from repro_torch.kernels import ref, rng
from repro_torch.utils import is_placed, to_device, tree_flatten

PyTree = Any


def _local_only(op: str, *tensors) -> None:
    """Refuse a ``DTensor`` (a tensor placed over a device mesh)."""
    for t in tensors:
        if is_placed(t):
            raise TypeError(f"{op} takes a rank's local tensors, got a DTensor: "
                            "pass its to_local() rows (repro_torch.utils.local)")


def _route(t, kernel, plain):
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for device {t.device}")


def _counted(t) -> bool:
    """Whether an op on ``t`` reports its formula cost: on a card or on
    ``meta``, while a count is open (on the CPU the plain version's ATen
    ops are counted as they run)."""
    return t.device.type != "cpu" and _cost.counting()


def _record_decode(q, k_cache) -> None:
    """The ring step's FLOPs and bytes, every slot read (chip_smoke.py's
    decode bound with all ``smax`` slots valid)."""
    N, KV, G, hd = q.shape
    smax, es = k_cache.shape[1], q.element_size()
    row = KV * hd * es
    _cost.record_kernel(4.0 * N * KV * G * hd * smax,
                        q.numel() * es * 2 + 2 * N * row + smax * 4
                        + 2 * N * (smax - 1) * row + 2 * N * row)


def _record_paged(q, k_pages, tables) -> None:
    """The paged step's FLOPs and bytes, every position of a slot's table
    read (chip_smoke.py's paged bound with each slot at its last
    position)."""
    C, S, KV, G, hd = q.shape
    ps, es = k_pages.shape[2], q.element_size()
    row, win = KV * hd * es, tables.shape[1] * ps
    _cost.record_kernel(4.0 * C * KV * G * hd * S * win,
                        q.numel() * es * 2 + 2 * C * S * row + tables.numel() * 4
                        + S * 4 + 2 * C * S * (win - 1) * row + 2 * C * S * row)


def fused_decode_step(q, k_new, v_new, k_cache, v_cache, valid, slot: int):
    """Ring-cache decode step.

    q: (N, H, hd); k_new, v_new: (N, KV, hd); caches: (N, smax, KV, hd),
    updated in place; valid: (smax,) int32 slot-validity mask (already
    includes the window and the just-written slot); slot: the ring slot of
    the new token.  Returns (o (N, H, hd), k_cache, v_cache).
    """
    _local_only("fused_decode_step", q, k_new, v_new, k_cache, v_cache)
    N, H, hd = q.shape
    KV = k_cache.shape[2]
    q4 = q.reshape(N, KV, H // KV, hd)
    if _counted(q):
        _record_decode(q4, k_cache)
    if q.device.type == "meta":
        return torch.empty_like(q), k_cache, v_cache
    step = _route(q, ds.decode_step, ref.decode_step_ref)
    o, kc, vc = step(q4, k_new.contiguous(), v_new.contiguous(), k_cache,
                     v_cache, valid, slot)
    return o.reshape(N, H, hd), kc, vc


def fused_paged_decode_step(q, k_new, v_new, k_pages, v_pages, tables, pos):
    """Paged decode step over one page pool per chain.

    q: (C, S, H, hd); k_new, v_new: (C, S, KV, hd); k_pages, v_pages:
    (C, n_pages, page_size, KV, hd), updated in place; tables: (S, maxp)
    int32 per-slot page table, shared by the chains; pos: (S,) int32
    absolute position per slot.  Returns (o (C, S, H, hd), k_pages, v_pages).
    """
    _local_only("fused_paged_decode_step", q, k_new, v_new, k_pages, v_pages)
    C, S, H, hd = q.shape
    KV = k_pages.shape[3]
    q5 = q.reshape(C, S, KV, H // KV, hd)
    if _counted(q):
        _record_paged(q5, k_pages, tables)
    if q.device.type == "meta":
        return torch.empty_like(q), k_pages, v_pages
    step = _route(q, ds.paged_decode_step, ref.paged_decode_step_ref)
    o, kp, vp = step(q5, k_new.contiguous(), v_new.contiguous(), k_pages,
                     v_pages, tables, pos)
    return o.reshape(C, S, H, hd), kp, vp


def _table(rows: np.ndarray, device) -> torch.Tensor:
    """Host table rows (uint32) as 32-bit words on ``device``: one copy,
    which does not stall the host (:func:`~repro_torch.utils.to_device`)."""
    return to_device(np.ascontiguousarray(rows).view(np.int32), device)


def fused_langevin_update(params: PyTree, grads: PyTree, seeds, gammas,
                          scales, skip=None, flags=None) -> PyTree:
    """Leafwise fused SGLD commit of C chain-stacked chains, **in place**
    on every leaf of ``params`` (``(C, *shape)``, as ``grads``): ``x[c] <-
    x[c] - gammas[c]*g[c] + scales[c]*xi_c``.

    Leaf ``i`` — in JAX's leaf order — of chain c draws its noise under the
    seed fold ``(s0 ^ 0x85EBCA6B·(i+1), s1 + i)`` of ``seeds[c]``
    (:func:`rng.leaf_seed`), its counter its element's index within the
    chain, so the port and ``repro.kernels.ops.fused_langevin_update``
    give every leaf of every chain the same stream.  seeds: C ``(s0, s1)``
    uint32 pairs; gammas, scales: C float32 values.  ``skip`` (C host
    bools, optional): skipped chains' rows are neither read nor written.
    ``flags`` (optional ``(C,)`` int32 on the parameters' device, zeroed by
    the caller): set for every chain any of whose updated elements, in any
    leaf, is NaN or Inf.  On a card one launch a leaf for every chain, from
    one table of every leaf's rows copied to the card once.  Returns
    ``params``."""
    leaves, _ = tree_flatten(params)
    gleaves, _ = tree_flatten(grads)
    _local_only("fused_langevin_update", *leaves, *gleaves)
    if len(gleaves) != len(leaves):
        raise ValueError(f"{len(gleaves)} gradient leaves for {len(leaves)} "
                         "parameter leaves")
    if leaves and _counted(leaves[0]):
        for x in leaves:
            _cost.record_kernel(_cost.LANGEVIN_OPS * x.numel(),
                                3 * x.element_size() * x.numel())
    if leaves and leaves[0].device.type == "meta":
        return params
    seeds_by_leaf = [[rng.leaf_seed(s, i) for s in seeds] for i in range(len(leaves))]
    if leaves and leaves[0].device.type == "cuda":
        table = _table(np.stack([lu.chain_rows(sl, gammas, scales, skip)
                                 for sl in seeds_by_leaf]), leaves[0].device)
        for i, (x, g) in enumerate(zip(leaves, gleaves)):
            C = x.shape[0]
            lu.langevin_update(x.view(C, -1), g.contiguous().view(C, -1), table[i],
                               flags)
        return params
    for x, g, sl in zip(leaves, gleaves, seeds_by_leaf):
        _route(x, None, ref.langevin_update_ref)(x, g.contiguous(), sl, gammas,
                                                 scales, skip, flags)
    return params


def randint_tables(keys_by_leaf, maxvals, heads, device):
    """Every leaf's chain table of the draws and the chains' ring heads,
    ``(leaves, C, 9)`` 32-bit words on a card ``device`` (one copy); on
    the CPU ``None`` (the plain versions take the keys and heads)."""
    if torch.device(device).type != "cuda":
        return None
    return _table(np.stack([dg.randint_rows(keys, maxvals, heads)
                            for keys in keys_by_leaf]), device)


def coordinate_delays(like, keys, maxvals, table=None):
    """Delays of C chains for one leaf ``like`` (``(C, *shape)``; only its
    size and device are read): ``(C, n)`` int32, row c bit for bit
    ``jax.random.randint(keys[c], (n,), 0, maxvals[c], int32)``.
    ``table``: this leaf's rows of :func:`randint_tables` (made here when
    not given)."""
    _local_only("coordinate_delays", like)
    n = like[0].numel()
    if _counted(like):
        _cost.record_kernel(_cost.DELAY_OPS * like.shape[0] * n, 4 * like.shape[0] * n)
    if like.device.type == "meta":
        return torch.empty((like.shape[0], n), dtype=torch.int32, device="meta")
    if like.device.type == "cuda":
        if table is None:
            table = _table(dg.randint_rows(keys, maxvals), like.device)
        return dg.coordinate_delays(table, n, maxvals)
    return _route(like, None, ref.coordinate_delays_ref)(keys, n, maxvals,
                                                          like.device)


def delay_gather(history, delays, heads):
    """W-Icon read of C chains of one leaf: history ``(C, depth, *shape)``,
    delays of ``(C, n)`` int32 (any shape with those elements) -> ``(C,
    *shape)``, element ``i`` of chain c from snapshot ``(heads[c] -
    delays[c, i]) mod depth`` (``heads``: C host ints)."""
    _local_only("delay_gather", history, delays)
    C, depth, shape = history.shape[0], history.shape[1], history.shape[2:]
    n = shape.numel()
    if _counted(history):
        _cost.record_kernel(4 * C * n, C * n * (4 + 2 * history.element_size()))
    if history.device.type == "meta":
        return torch.empty((C, *shape), dtype=history.dtype, device="meta")
    gather = _route(history, dg.delay_gather, ref.delay_gather_ref)
    out = gather(history.reshape(C, depth, -1), delays.reshape(C, -1),
                 [int(h) for h in heads])
    return out.reshape(C, *shape)


def wicon_read(history, keys, maxvals, heads, table=None):
    """One-pass W-Icon read of C chains of one leaf: history ``(C, depth,
    *shape)`` -> ``(C, *shape)``, element ``i`` of chain c from snapshot
    ``(heads[c] - d_ci) mod depth`` with ``d_c = jax.random.randint(keys[c],
    shape, 0, maxvals[c], int32)``, flat element ``i`` (1 <= maxvals[c] <=
    depth; ``heads``: C host ints).  On a card one launch for every chain,
    drawing the delays in registers (no delay tensor is made); ``table``:
    this leaf's rows of :func:`randint_tables` (made here when not
    given)."""
    _local_only("wicon_read", history)
    C, depth, shape = history.shape[0], history.shape[1], history.shape[2:]
    h = history.reshape(C, depth, -1)
    heads = [int(v) for v in heads]
    if _counted(history):
        n = C * shape.numel()
        _cost.record_kernel(_cost.DELAY_OPS * n, 2 * history.element_size() * n)
    if history.device.type == "meta":
        return torch.empty((C, *shape), dtype=history.dtype, device="meta")
    if history.device.type == "cuda":
        if table is None:
            table = _table(dg.randint_rows(keys, maxvals, heads), history.device)
        out = dg.wicon_read(h, table, maxvals, heads)
    else:
        out = _route(history, None, ref.wicon_read_ref)(h, keys, maxvals, heads)
    return out.reshape(C, *shape)
