"""Checkpointing: flat-path npz save and restore of parameter and state
trees (port of ``repro.checkpoint.io``; the file format is the JAX
package's, so a file written by either package restores in the other).

- Every leaf is one npz member named by its path, the path elements joined
  by ``##`` as ``jax.tree_util.tree_map_with_path`` names them: a dict key
  as itself (keys sorted), a list or tuple index as its number, a named
  tuple's or a dataclass's field as ``.name`` (a dataclass field whose
  metadata says ``static`` — a ring's depth — is not a leaf; None is no
  leaf).
- bfloat16 leaves are stored as their uint16 bits and listed under
  ``__bf16__`` (torch writes and reads them through an int16 view: no
  ``ml_dtypes`` is needed).
- ``__crc_paths__`` / ``__crc_vals__`` hold each leaf's CRC32 (of its
  stored bytes), ``__step__`` the optional step.
- The write is atomic: a temporary file in the target's directory, then a
  rename.

A device tensor is copied to the host once, a leaf at a time as the file
is written.  A truncated or bit-flipped file raises
:class:`CorruptCheckpointError` naming the damaged leaf.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

PyTree = Any
_SEP = "##"
_BF16_KEY = "__bf16__"
_CRC_PATHS_KEY = "__crc_paths__"
_CRC_VALS_KEY = "__crc_vals__"
_META_KEYS = ("__step__", _BF16_KEY, _CRC_PATHS_KEY, _CRC_VALS_KEY)


class CorruptCheckpointError(RuntimeError):
    """A checkpoint file is unreadable or fails its integrity manifest
    (truncated write, bit flip, damaged zip member)."""


def _children(tree):
    """``[(path element, child), ...]`` of a tree node in JAX's order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)
                if not f.metadata.get("static", False)]
    return None


def leaf_paths(tree: PyTree, prefix: str = "") -> list:
    """``[(path, leaf), ...]`` of ``tree`` in JAX's leaf order, paths as
    the JAX package writes them."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += leaf_paths(child, f"{prefix}{_SEP}{name}" if prefix else name)
    return out


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree) if not f.metadata.get("static", False)})
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, bool]:
    """``(stored array, is bf16)``: a tensor copied to the host once (bf16
    as its uint16 bits), anything else through ``np.asarray``."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), True
        return t.cpu().numpy(), False
    return np.asarray(leaf), False


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def save_checkpoint(path: str, tree: PyTree, step: int | None = None) -> None:
    """Write ``tree`` to ``path`` (npz, atomically), with ``step`` as
    ``__step__`` when given."""
    flat, bf16_paths = {}, []
    for p, leaf in leaf_paths(tree):
        flat[p], is_bf16 = _to_host(leaf)
        if is_bf16:
            bf16_paths.append(p)
    if bf16_paths:
        flat[_BF16_KEY] = np.asarray(bf16_paths)
    crc_paths = sorted(flat)  # leaf paths only — meta keys join below
    flat[_CRC_PATHS_KEY] = np.asarray(crc_paths)
    flat[_CRC_VALS_KEY] = np.asarray([_crc(flat[p]) for p in crc_paths], np.uint32)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _read_arrays(path: str) -> dict:
    """Every member of an npz, failing loudly on damage: truncation and bit
    flips surface from ``zipfile`` / numpy as many kinds of error, and a
    CRC mismatch as none; all become :class:`CorruptCheckpointError`."""
    try:
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
    except (zipfile.BadZipFile, zlib.error, ValueError, KeyError, EOFError,
            OSError) as e:
        raise CorruptCheckpointError(f"{path}: unreadable checkpoint "
                                     f"({type(e).__name__}: {e})") from e
    if _CRC_PATHS_KEY in arrays:  # a file without the manifest still loads
        for p, want in zip(arrays[_CRC_PATHS_KEY].tolist(),
                           arrays[_CRC_VALS_KEY].tolist()):
            if p not in arrays:
                raise CorruptCheckpointError(
                    f"{path}: leaf {p!r} in the CRC manifest is missing")
            if _crc(arrays[p]) != int(want):
                raise CorruptCheckpointError(
                    f"{path}: leaf {p!r} fails its CRC32 — the file was "
                    "truncated or bit-flipped since it was written")
    return arrays


def _to_tensor(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    if bf16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # writable, owns its memory
    return t.to(device)


def _device_of(leaf, device):
    if device is not None:
        return torch.device(device)
    return leaf.device if torch.is_tensor(leaf) and leaf.device.type != "meta" \
        else torch.device("cpu")


def restore_checkpoint(path: str, like: PyTree, device=None) -> PyTree:
    """Restore into the structure of ``like``: every leaf a tensor with
    the dtype on disk, on ``device`` (default: that of ``like``'s leaf,
    the host for a non-tensor or a ``meta`` leaf).

    Raises :class:`CorruptCheckpointError` when the file is truncated,
    bit-flipped, or otherwise fails its per-leaf CRC manifest; ``KeyError``
    when a leaf of ``like`` is not in it."""
    data = _read_arrays(path)
    bf16 = set(data[_BF16_KEY].tolist()) if _BF16_KEY in data else set()
    items = leaf_paths(like)
    missing = [p for p, _ in items if p not in data]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    leaves = (_to_tensor(data[p], p in bf16, _device_of(leaf, device))
              for p, leaf in items)
    return _rebuild(like, leaves)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def restore_ensemble(path: str, like: PyTree, *, num_chains: int | None = None,
                     device=None) -> PyTree:
    """Restore chain-stacked ("ensemble layout") parameters for serving.

    ``like`` is the *single-chain* parameter structure (shapes only are
    read; a ``meta`` tree will do); the shapes on disk decide the layout.
    An ensemble checkpoint — every leaf with one extra leading axis of a
    common chain count (what
    :meth:`~repro_torch.cluster.executor.ClusterEngine.save_ensemble`
    writes) — restores as it is; a single-model checkpoint is copied to
    ``num_chains`` identical chains (required then).  Mixed or mismatched
    layouts fail loudly, as does a damaged file
    (:class:`CorruptCheckpointError`)."""
    tree = restore_checkpoint(path, like, device=device)
    got = [t for _, t in leaf_paths(tree)]
    want = [_shape(x) for _, x in leaf_paths(like)]
    if all(tuple(g.shape) == w for g, w in zip(got, want)):
        if num_chains is None:
            raise ValueError(
                f"{path} holds a single-model checkpoint; pass num_chains= "
                "to broadcast it into a chain bank")
        n = int(num_chains)
        return _rebuild(tree, iter([g[None].expand(n, *g.shape).clone() for g in got]))
    stacked = [g.dim() > 0 and tuple(g.shape[1:]) == w for g, w in zip(got, want)]
    chain_counts = {g.shape[0] for g, s in zip(got, stacked) if s}
    if not all(stacked) or len(chain_counts) != 1:
        raise ValueError(f"{path} is neither a single-model nor a chain-stacked "
                         "checkpoint for the given `like` structure")
    c = chain_counts.pop()
    if num_chains is not None and num_chains != c:
        raise ValueError(f"{path} holds {c} chains, asked for {num_chains}")
    return tree


def checkpoint_step(path: str) -> int | None:
    """The ``__step__`` a checkpoint was saved with, or None."""
    data = _read_arrays(path)
    if "__step__" in data:
        return int(data["__step__"])
    return None
