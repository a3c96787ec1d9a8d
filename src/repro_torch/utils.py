"""Small shared utilities: nested-dict tree helpers, shape math, devices.

Trees are nested dicts / lists / tuples of tensors, the JAX package's
parameter layout.  Leaves are ordered as ``jax.tree_util`` orders them —
dict keys sorted — everywhere: the fused update folds a leaf's index into
its noise seed, and :func:`leaf_keys` hands leaf ``i`` the ``i``-th split
key, so any other order would give a leaf another leaf's random stream.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over nested dicts / lists / tuples (the
    parameter and cache layout the JAX package uses)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


_LEAF = object()  # a leaf's place in a treedef


# module-level recursions: a recursive closure is a reference cycle
# (function -> cell -> function) that would keep every leaf it saw alive
# until the garbage collector runs — parameter-sized tensors, at full width
def _flatten_into(t, leaves: list):
    if isinstance(t, dict):
        return {k: _flatten_into(t[k], leaves) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_flatten_into(v, leaves) for v in t)
    leaves.append(t)
    return _LEAF


def _build(t, it):
    if isinstance(t, dict):
        return {k: _build(v, it) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_flatten(tree: PyTree) -> tuple[list, PyTree]:
    """``(leaves, treedef)`` in JAX's leaf order (dict keys sorted);
    :func:`tree_unflatten` inverts it."""
    leaves: list = []
    return leaves, _flatten_into(tree, leaves)


def tree_unflatten(treedef: PyTree, leaves) -> PyTree:
    """The tree of ``treedef`` (from :func:`tree_flatten`) with ``leaves``
    put in, in order."""
    return _build(treedef, iter(leaves))


def tree_leaves(tree: PyTree) -> list:
    """Leaves of a nested dict / list / tuple, in JAX's order."""
    return tree_flatten(tree)[0]


def leaf_keys(key, tree: PyTree) -> list:
    """One key per leaf, in JAX's leaf order: leaf ``i`` gets
    ``split(key, n_leaves)[i]`` (``repro.utils.tree_keys``, flattened —
    a key is a ``(k0, k1)`` tuple, which a tree walk would take apart)."""
    from repro_torch.kernels import rng

    return rng.split(key, len(tree_leaves(tree)))


def tree_zeros_like(a: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, a)


def tree_add_scaled(a: PyTree, b: PyTree, scale) -> PyTree:
    """a + scale * b, leafwise."""
    return tree_map(lambda x, y: x + scale * y, a, b)


def tree_broadcast_leading(a: PyTree, n: int) -> PyTree:
    """Every leaf copied ``n`` times along a new leading axis (the slots
    of an iterate ring)."""
    return tree_map(lambda x: x[None].expand(n, *x.shape).clone(), a)


def to_device(array, device) -> torch.Tensor:
    """A small host array (numpy, or a tensor) as a tensor on ``device``
    without stalling the host: bound for a card, host data is staged in
    pinned memory and copied on the current stream with
    ``non_blocking=True`` (a copy from pageable memory waits for the stream
    to drain).  PyTorch's pinned-memory cache records the copy and holds
    the staging buffer until it has run."""
    t = array if torch.is_tensor(array) else torch.from_numpy(np.array(array))
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) needs a card and raises without one: there is no silent
    CPU path — the CPU runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:  # the index tensors report: "cuda" -> "cuda:0"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def bucket_size(n: int, buckets=None) -> int:
    """Smallest bucket ladder rung holding ``n`` items: the next power of two,
    or the smallest entry of an explicit ``buckets`` ladder (which is a
    contract — ``n`` larger than the top rung fails loudly instead of
    silently extending the ladder)."""
    if n < 1:
        raise ValueError(f"need at least one item, got {n}")
    if buckets is None:
        return 1 << (n - 1).bit_length()
    fits = [b for b in buckets if b >= n]
    if not fits:
        raise ValueError(f"{n} items exceed the largest bucket "
                         f"{max(buckets)}; pass a deeper `buckets` ladder")
    return min(fits)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
