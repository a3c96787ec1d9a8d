"""Carry parameters over from the JAX package (no JAX needed here).

:func:`from_jax_params` takes the JAX package's parameter tree after
``jax.device_get`` / ``np.asarray`` — nested dicts of numpy arrays — and
returns the port's tree of tensors.  One chain (``embed/w`` of rank 2)
gains a leading chain axis of 1; a chain-stacked bank keeps its ``(C, ...)``
layout, which is the port's.
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
    fp32).  A single chain becomes a bank of one."""
    dev = resolve_device(device)
    out = tree_map(lambda a: _to_tensor(a, dev, dtype), tree)
    if out["embed"]["w"].dim() == 2:
        out = tree_map(lambda t: t[None], out)
    return out
