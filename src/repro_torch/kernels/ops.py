"""The kernels in model layout (port of ``repro.kernels.ops``): the two
decode steps, the fused Langevin update over a parameter tree, the W-Icon
delay draw and gather, and the one-pass W-Icon read that draws and
gathers in one launch.

Dispatch goes by the tensors' device, and nothing else: on a CUDA tensor
the op **is** the hand-written kernel (:mod:`~repro_torch.kernels.
decode_step`, :mod:`~repro_torch.kernels.langevin_update`,
:mod:`~repro_torch.kernels.delay_gather`), which launches or raises —
there is no fallback; on a CPU tensor it is the plain version
(:mod:`repro_torch.kernels.ref`).  Either way caches, pools and the
updated parameters change in place.
"""

from __future__ import annotations

from typing import Any

from repro_torch.kernels import decode_step as ds
from repro_torch.kernels import delay_gather as dg
from repro_torch.kernels import langevin_update as lu
from repro_torch.kernels import ref, rng
from repro_torch.utils import tree_flatten, tree_map

PyTree = Any


def _route(t, kernel, plain):
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for device {t.device}")


def fused_decode_step(q, k_new, v_new, k_cache, v_cache, valid, slot: int):
    """Ring-cache decode step.

    q: (N, H, hd); k_new, v_new: (N, KV, hd); caches: (N, smax, KV, hd),
    updated in place; valid: (smax,) int32 slot-validity mask (already
    includes the window and the just-written slot); slot: the ring slot of
    the new token.  Returns (o (N, H, hd), k_cache, v_cache).
    """
    N, H, hd = q.shape
    KV = k_cache.shape[2]
    step = _route(q, ds.decode_step, ref.decode_step_ref)
    o, kc, vc = step(q.reshape(N, KV, H // KV, hd), k_new.contiguous(),
                     v_new.contiguous(), k_cache, v_cache, valid, slot)
    return o.reshape(N, H, hd), kc, vc


def fused_paged_decode_step(q, k_new, v_new, k_pages, v_pages, tables, pos):
    """Paged decode step over one page pool per chain.

    q: (C, S, H, hd); k_new, v_new: (C, S, KV, hd); k_pages, v_pages:
    (C, n_pages, page_size, KV, hd), updated in place; tables: (S, maxp)
    int32 per-slot page table, shared by the chains; pos: (S,) int32
    absolute position per slot.  Returns (o (C, S, H, hd), k_pages, v_pages).
    """
    C, S, H, hd = q.shape
    KV = k_pages.shape[3]
    step = _route(q, ds.paged_decode_step, ref.paged_decode_step_ref)
    o, kp, vp = step(q.reshape(C, S, KV, H // KV, hd), k_new.contiguous(),
                     v_new.contiguous(), k_pages, v_pages, tables, pos)
    return o.reshape(C, S, H, hd), kp, vp


def fused_langevin_update(params: PyTree, grads: PyTree, seed, gamma,
                          scale) -> PyTree:
    """Leafwise fused SGLD commit, **in place** on every leaf of
    ``params``: ``x <- x - gamma*g + scale*xi``.

    Leaf ``i`` — in JAX's leaf order — draws its noise under the seed fold
    ``(s0 ^ 0x85EBCA6B·(i+1), s1 + i)`` (:func:`rng.leaf_seed`), so the port
    and ``repro.kernels.ops.fused_langevin_update`` give every leaf the same
    stream.  seed: ``(s0, s1)`` uint32 ints; gamma, scale: float32 scalars.
    One kernel launch per leaf on a card.  Returns ``params``."""
    leaves, _ = tree_flatten(params)
    gleaves, _ = tree_flatten(grads)
    if len(gleaves) != len(leaves):
        raise ValueError(f"{len(gleaves)} gradient leaves for {len(leaves)} "
                         "parameter leaves")
    for i, (x, g) in enumerate(zip(leaves, gleaves)):
        step = _route(x, lu.langevin_update, ref.langevin_update_ref)
        step(x, g.contiguous(), rng.leaf_seed(seed, i), gamma, scale)
    return params


def coordinate_delays(key, like, maxval: int):
    """Delays ``U{0..maxval-1}`` (int32) for every coordinate of ``like``
    (a tensor; only its size and device are read), bit for bit
    ``jax.random.randint(key, like.shape, 0, maxval, int32)``, flat."""
    draw = _route(like, dg.coordinate_delays, ref.coordinate_delays_ref)
    return draw(key, like.numel(), int(maxval), like.device)


def delay_gather_leaf(history, delays, head: int):
    """W-Icon read of one leaf: history ``(depth, *shape)``, delays of
    ``shape``'s size (int32) -> ``(*shape)`` with element ``i`` taken from
    snapshot ``(head - delays[i]) mod depth``."""
    depth, shape = history.shape[0], history.shape[1:]
    gather = _route(history, dg.delay_gather, ref.delay_gather_ref)
    out = gather(history.reshape(depth, -1), delays.reshape(-1), int(head))
    return out.reshape(shape)


def wicon_read_leaf(history, key, maxval: int, head: int):
    """One-pass W-Icon read of one leaf: history ``(depth, *shape)`` ->
    ``(*shape)``, element ``i`` from snapshot ``(head - d_i) mod depth``
    with ``d_i = jax.random.randint(key, shape, 0, maxval, int32)``, flat
    element ``i`` (1 <= maxval <= depth).  On a card one launch, drawing
    the delays in registers; no delay tensor is made."""
    depth, shape = history.shape[0], history.shape[1:]
    read = _route(history, dg.wicon_read, ref.wicon_read_ref)
    out = read(history.reshape(depth, -1), key, int(maxval), int(head))
    return out.reshape(shape)


def fused_delay_gather(ring_history: PyTree, delays: PyTree, head: int,
                       depth: int) -> PyTree:
    """W-Icon read over a ring-buffer tree (leaves ``(depth, *shape)``)
    with a per-coordinate delay tree shaped like the parameters."""
    del depth  # each leaf's leading axis
    return tree_map(lambda h, d: delay_gather_leaf(h, d.to(h.device), head),
                    ring_history, delays)
