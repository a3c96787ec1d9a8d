"""Carry parameters over from the JAX package (no JAX needed here).

:func:`from_jax_params` takes the JAX package's parameter tree after
``jax.device_get`` / ``np.asarray`` — nested dicts of numpy arrays — and
returns the port's tree of tensors.  One chain (``embed/w`` of rank 2)
gains a leading chain axis of 1; a chain-stacked bank keeps its ``(C, ...)``
layout, which is the port's.  :func:`drop_unit_chain` is the way back, for
the checkpoints the JAX package reads.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_map

PyTree = Any


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 has no torch.from_numpy route: widen to float32
        # (exact) and narrow back
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_params(tree: PyTree, device="cuda", dtype=None) -> PyTree:
    """The port's parameters from a JAX parameter tree of numpy arrays.

    ``dtype`` (optional) casts every floating leaf; by default each leaf
    keeps its own dtype (bf16 weights stay bf16, fp32 norm scales stay
    fp32).  A single chain becomes a bank of one.  A tree that is no
    model's (a regression bank ``(C, 5)``, an MLP bank) crosses leaf for
    leaf as it is."""
    dev = resolve_device(device)
    out = tree_map(lambda a: _to_tensor(a, dev, dtype), tree)
    if isinstance(out, dict) and "embed" in out and out["embed"]["w"].dim() == 2:
        out = tree_map(lambda t: t[None], out)
    return out


def drop_unit_chain(tree: PyTree) -> PyTree:
    """A model tree in the JAX package's layout, for files the JAX package
    reads: the port's one chain is a bank of one (leaves ``(1, ...)``,
    ``embed/w`` of rank 3), and a chain-stacked ensemble of such chains
    has leaves ``(C, 1, ...)`` (rank 4); both lose the axis of 1 (views,
    no copies).  Any other tree — already in that layout, or no model
    tree — is returned as it is."""
    embed = tree.get("embed") if isinstance(tree, dict) else None
    w = embed.get("w") if isinstance(embed, dict) else None
    if not torch.is_tensor(w):
        return tree
    if w.dim() == 3 and w.shape[0] == 1:
        return tree_map(lambda t: t[0], tree)
    if w.dim() == 4 and w.shape[1] == 1:
        return tree_map(lambda t: t[:, 0], tree)
    return tree
