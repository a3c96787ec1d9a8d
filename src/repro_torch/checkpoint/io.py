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
is written; a restore reads the file one leaf at a time.  A truncated or
bit-flipped file raises :class:`CorruptCheckpointError` naming the damaged
leaf.

Placed trees (chains split over a device mesh, ``DTensor`` leaves with
``Shard`` on one mesh axis): :func:`save_checkpoint` gathers each placed
leaf into the host memory of the rank at the mesh's origin, which writes
the file, and every rank of the mesh waits at a barrier;
:func:`restore_checkpoint` and :func:`restore_ensemble` into a placed
template move only the rank's rows to its device.  The file is the same
as an unplaced run's.
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

from repro_torch.utils import is_placed, mesh_barrier

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


def _shard_axis(leaf) -> tuple:
    """``(mesh axis index, tensor dim)`` a placed leaf is sharded on, or
    None for a replicated one; other placements are refused."""
    found = []
    for i, pl in enumerate(leaf.placements):
        if pl.is_shard():
            found.append((i, pl.dim))
        elif not pl.is_replicate():
            raise ValueError(f"a checkpoint leaf placed {leaf.placements}: only "
                             "Shard / Replicate placements are read and written")
    if len(found) > 1:
        raise ValueError(f"a checkpoint leaf sharded over {len(found)} mesh axes "
                         "(one is read and written)")
    return found[0] if found else None


def _is_origin(mesh) -> bool:
    """Whether this rank sits at the mesh's origin (every coordinate 0)."""
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


def _gather_to_origin(leaf):
    """A placed leaf whole on the host of the mesh's origin rank (None on
    the others): the origin's chain-axis group sends it their rows, one
    rank after another; the ranks off that group send nothing."""
    import torch.distributed as dist

    mesh, mine = leaf.device_mesh, leaf.to_local()
    axis = _shard_axis(leaf)
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    if axis is None:
        return mine.cpu() if _is_origin(mesh) else None
    i, dim = axis
    if any(c for j, c in enumerate(coord) if j != i):
        return None  # a replica of rows the origin's group holds
    group = mesh.get_group(i)
    if coord[i]:
        dist.send(mine.contiguous(), dst=dist.get_global_rank(group, 0), group=group)
        return None
    out = torch.empty(tuple(leaf.shape), dtype=mine.dtype)
    n = mine.shape[dim]
    out.narrow(dim, 0, n).copy_(mine)
    buf = torch.empty_like(mine)
    for r in range(1, mesh.shape[i]):
        dist.recv(buf, src=dist.get_global_rank(group, r), group=group)
        out.narrow(dim, r * n, n).copy_(buf)
    return out


def save_checkpoint(path: str, tree: PyTree, step: int | None = None) -> None:
    """Write ``tree`` to ``path`` (npz, atomically), with ``step`` as
    ``__step__`` when given.  A tree with placed leaves is written by the
    mesh's origin rank (its placed leaves gathered there leaf by leaf);
    every rank of the mesh calls this and returns once the file is in
    place."""
    items = leaf_paths(tree)
    meshes = [leaf.device_mesh for _, leaf in items if is_placed(leaf)]
    writer = not meshes or _is_origin(meshes[0])
    flat, bf16_paths = {}, []
    for p, leaf in items:
        if is_placed(leaf):
            leaf = _gather_to_origin(leaf)
        if not writer:
            continue
        flat[p], is_bf16 = _to_host(leaf)
        if is_bf16:
            bf16_paths.append(p)
    if writer:
        _write(path, flat, bf16_paths, step)
    if meshes:
        mesh_barrier(meshes[0])


def _write(path: str, flat: dict, bf16_paths: list, step) -> None:
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


class _Npz:
    """An npz read one member at a time (a restore holds one leaf on the
    host at a time), each member checked against the CRC manifest as it is
    read; leaving the ``with`` block checks the members not read, so a
    damaged leaf anywhere in the file fails the read.  Damage surfaces
    from ``zipfile`` / numpy as many kinds of error, and a CRC mismatch as
    none; all become :class:`CorruptCheckpointError`."""

    _DAMAGE = (zipfile.BadZipFile, zlib.error, ValueError, KeyError, EOFError, OSError)

    def __init__(self, path: str):
        self.path, self._seen = path, set()
        try:
            self._npz = np.load(path)
            self.files = set(self._npz.files)
            self._crc = {}
            if _CRC_PATHS_KEY in self.files:  # a file without the manifest still loads
                self._crc = dict(zip(self._npz[_CRC_PATHS_KEY].tolist(),
                                     self._npz[_CRC_VALS_KEY].tolist()))
            self.bf16 = (set(self._npz[_BF16_KEY].tolist())
                         if _BF16_KEY in self.files else set())
        except self._DAMAGE as e:
            raise CorruptCheckpointError(f"{path}: unreadable checkpoint "
                                         f"({type(e).__name__}: {e})") from e
        missing = [p for p in self._crc if p not in self.files]
        if missing:
            self._npz.close()
            raise CorruptCheckpointError(
                f"{path}: leaf {missing[0]!r} in the CRC manifest is missing")

    def __enter__(self):
        return self

    def __exit__(self, kind, *_):
        try:
            if kind is None:
                for p in sorted(self._crc.keys() - self._seen):
                    self[p]
        finally:
            self._npz.close()

    def __getitem__(self, p: str) -> np.ndarray:
        try:
            a = self._npz[p]
        except self._DAMAGE as e:
            raise CorruptCheckpointError(f"{self.path}: unreadable leaf {p!r} "
                                         f"({type(e).__name__}: {e})") from e
        if p in self._crc and _crc(a) != int(self._crc[p]):
            raise CorruptCheckpointError(
                f"{self.path}: leaf {p!r} fails its CRC32 — the file was "
                "truncated or bit-flipped since it was written")
        self._seen.add(p)
        return a

    def leaves(self, like: PyTree) -> list:
        """``leaf_paths(like)``, with a ``KeyError`` when the file lacks
        one of them."""
        items = leaf_paths(like)
        missing = [p for p, _ in items if p not in self.files]
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
        return items


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


def _rows_of(a: np.ndarray, leaf):
    """The rows of the whole array ``a`` that the placed template ``leaf``
    holds on this rank (all of it for a replicated leaf)."""
    axis = _shard_axis(leaf)
    if axis is None:
        return a
    i, dim = axis
    n = leaf.to_local().shape[dim]
    r = leaf.device_mesh.get_local_rank(i)
    return np.take(a, np.arange(r * n, (r + 1) * n), axis=dim)


def _restored(data: _Npz, p: str, leaf, device) -> torch.Tensor:
    """Leaf ``p`` of the file as ``leaf`` of the template wants it: on
    ``device`` (default: ``leaf``'s), or — a placed ``leaf`` — the rank's
    rows on its local device, placed as ``leaf`` is."""
    if not is_placed(leaf):
        return _to_tensor(data[p], p in data.bf16, _device_of(leaf, device))
    from torch.distributed.tensor import DTensor

    t = _to_tensor(_rows_of(data[p], leaf), p in data.bf16, leaf.to_local().device)
    return DTensor.from_local(t, leaf.device_mesh, leaf.placements, run_check=False)


def restore_checkpoint(path: str, like: PyTree, device=None) -> PyTree:
    """Restore into the structure of ``like``: every leaf a tensor with
    the dtype on disk, on ``device`` (default: that of ``like``'s leaf,
    the host for a non-tensor or a ``meta`` leaf).  A placed leaf of
    ``like`` (a ``DTensor``) restores placed as it is: the rank's rows on
    its local device.  The file is read one leaf at a time.

    Raises :class:`CorruptCheckpointError` when the file is truncated,
    bit-flipped, or otherwise fails its per-leaf CRC manifest; ``KeyError``
    when a leaf of ``like`` is not in it."""
    with _Npz(path) as data:
        leaves = [_restored(data, p, leaf, device) for p, leaf in data.leaves(like)]
    return _rebuild(like, iter(leaves))


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def restore_ensemble(path: str, like: PyTree, *, num_chains: int | None = None,
                     device=None, mesh=None, chain_axis: str = "data",
                     specs: PyTree = None) -> PyTree:
    """Restore chain-stacked ("ensemble layout") parameters for serving.

    ``like`` is the *single-chain* parameter structure (shapes only are
    read; a ``meta`` tree will do); the shapes on disk decide the layout.
    An ensemble checkpoint — every leaf with one extra leading axis of a
    common chain count (what
    :meth:`~repro_torch.cluster.executor.ClusterEngine.save_ensemble`
    writes) — restores as it is; a single-model checkpoint is copied to
    ``num_chains`` identical chains (required then).  Mixed or mismatched
    layouts fail loudly, as does a damaged file
    (:class:`CorruptCheckpointError`).  The file is read one leaf at a
    time, each on ``device`` (default: that of ``like``'s leaf, the host
    for a ``meta`` one).

    With ``mesh`` (a ``DeviceMesh``) the bank comes back placed, its
    chains split over ``chain_axis``: each rank keeps only its block's
    rows.  With ``specs`` too (one chain's spec tree beside ``like``, as
    :func:`~repro_torch.models.common.model_specs` gives it: a 2-D bank)
    each rank keeps only its block of each chain's tensors, cut from the
    leaf as it is read."""
    from repro_torch.utils import (chain_block, local_block, paired_leaves,
                                   place_chains, spec_placements)

    def block(count: int) -> slice:
        return slice(0, count) if mesh is None else chain_block(mesh, chain_axis, count)

    layout, count, out = None, None, []
    with _Npz(path) as data:
        items = data.leaves(like)
        leaf_specs = (paired_leaves(like, specs) if specs is not None
                      else [None] * len(items))
        for (p, leaf), spec in zip(items, leaf_specs):
            a, want = data[p], _shape(leaf)
            kind = ("single" if a.shape == want else
                    "stacked" if a.ndim > 0 and a.shape[1:] == want else None)
            if kind is None or layout not in (None, kind) or \
                    (kind == "stacked" and count not in (None, a.shape[0])):
                raise ValueError(f"{path} is neither a single-model nor a "
                                 "chain-stacked checkpoint for the given `like` "
                                 "structure")
            layout = kind
            if kind == "stacked":
                count = a.shape[0]
                a = a[block(count)]
            if spec is not None:  # the rank's block of each chain's tensor
                lead = (None,) if kind == "stacked" else ()
                a = local_block(a, mesh, spec_placements(mesh, lead + tuple(spec)))
            out.append(_to_tensor(a, p in data.bf16, _device_of(leaf, device)))
            del a
    if layout != "stacked":
        if num_chains is None:
            raise ValueError(f"{path} holds a single-model checkpoint; pass "
                             "num_chains= to broadcast it into a chain bank")
        rows = block(int(num_chains))
        out = [t[None].expand(rows.stop - rows.start, *t.shape).clone() for t in out]
    elif num_chains is not None and num_chains != count:
        raise ValueError(f"{path} holds {count} chains, asked for {num_chains}")
    tree = _rebuild(like, iter(out))
    return tree if mesh is None else place_chains(tree, mesh, chain_axis, specs)


def checkpoint_step(path: str) -> int | None:
    """The ``__step__`` a checkpoint was saved with, or None (the whole
    file checked)."""
    with _Npz(path) as data:
        return int(data["__step__"]) if "__step__" in data.files else None
