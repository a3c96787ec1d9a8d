"""Small shared utilities: nested-dict tree helpers, shape math, devices."""

from __future__ import annotations

from typing import Any, Callable, Iterator

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


def tree_leaves(tree: PyTree) -> list:
    """Leaves of a nested dict / list / tuple, in insertion order."""
    return list(_iter_leaves(tree))


def _iter_leaves(tree: PyTree) -> Iterator:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_leaves(v)
    else:
        yield tree


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
