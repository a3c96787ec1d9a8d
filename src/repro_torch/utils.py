"""Small shared utilities: nested-dict tree helpers, shape math, devices,
and the placement of chains over a device mesh.

Trees are nested dicts / lists / tuples of tensors, the JAX package's
parameter layout.  Leaves are ordered as ``jax.tree_util`` orders them —
dict keys sorted — everywhere: the fused update folds a leaf's index into
its noise seed, and :func:`leaf_keys` hands leaf ``i`` the ``i``-th split
key, so any other order would give a leaf another leaf's random stream.

Placement (the counterparts of the JAX package's ``shard_map`` and
``NamedSharding(mesh, P(chain_axis))``): a chain-stacked tensor placed over
a ``torch.distributed.device_mesh.DeviceMesh`` is a ``DTensor`` with
``Shard(0)`` on the chain axis and ``Replicate()`` on the other mesh axes;
each rank holds the contiguous block of chains :func:`chain_block` names.
A 2-D bank (``shard_params``) also splits each chain's tensors over
``model`` by a spec (``P(chain_axis, *spec)``): ``Shard(1 + i)`` on each
mesh axis ``spec[i]`` names; a chain trained on the model axis (a bank of
one) replicates the chain axis, its other axes holding the batch.
:func:`place_chains` wraps a rank's block, :func:`local_block` cuts it from
a whole tensor (:func:`block_slices` names it), :func:`local` unwraps it
(the body of a ``shard_map``), :func:`place_like` places local results as
their inputs were, :func:`gather_chains` gathers the whole (``np.asarray``
of a sharded JAX array) and :func:`gather_rows` all-gathers one local
block over the chain axis; :func:`all_gather` is the gather the chain and
model axes run.
"""

from __future__ import annotations

import dataclasses
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


# ---------------------------------------------------------------------------
# placement over a device mesh: chains split over one mesh axis
# ---------------------------------------------------------------------------
def is_placed(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a tensor placed over a device
    mesh)."""
    if type(x) is torch.Tensor or not torch.is_tensor(x):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def mesh_axis(mesh, axis: str) -> int:
    """The index of the named axis ``axis`` of a ``DeviceMesh``; a
    ``TypeError`` for anything that is not a ``DeviceMesh``, a
    ``ValueError`` for a mesh without that axis."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh= takes a torch.distributed.device_mesh.DeviceMesh "
                        "(repro_torch.launch.mesh.make_debug_mesh, or "
                        f"init_device_mesh), got {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} to place the chains on "
                         f"(its axes: {names})")
    return names.index(axis)


def chain_block(mesh, axis: str, num_chains: int) -> slice:
    """This rank's contiguous block of ``num_chains`` chains split over the
    mesh axis ``axis`` — the rows ``P(axis)`` gives a device; the chain
    count must divide evenly (the JAX package's message)."""
    i = mesh_axis(mesh, axis)
    n = mesh.shape[i]
    if num_chains % n:
        raise ValueError(f"num_chains={num_chains} must be divisible by mesh "
                         f"axis {axis!r} (size {n})")
    per = num_chains // n
    r = mesh.get_local_rank(i)
    return slice(r * per, (r + 1) * per)


def spec_placements(mesh, spec) -> list:
    """The ``DTensor`` placements of a tensor whose dimension ``d`` is split
    over the mesh axes ``spec[d]`` names (an axis name, a tuple of them, or
    None): ``Shard(d)`` on each such axis, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of the mesh "
                                 f"(its axes: {names})")
            i = names.index(a)
            if out[i].is_shard():
                raise ValueError(f"spec {spec} names the mesh axis {a!r} twice")
            out[i] = Shard(d)
    return out


def chain_placements(mesh, axis, dim: int = 0, spec=None) -> list:
    """``Shard(dim)`` on the mesh axis ``axis``, ``Replicate()`` on the
    others; with ``spec`` (one chain's spec, a 2-D bank) also
    ``Shard(dim + 1 + i)`` on each mesh axis ``spec[i]`` names.  ``axis``
    None replicates the chains (a training chain on the model axis, whose
    other axes hold its batch)."""
    if axis is not None:
        mesh_axis(mesh, axis)
    return spec_placements(mesh, (None,) * dim + (axis,) + tuple(spec or ()))


def block_slices(shape, mesh, placements) -> tuple:
    """The slice a dimension of the whole ``shape`` that this rank holds
    under ``placements`` (:func:`local_block`'s cut)."""
    out = [slice(0, n) for n in shape]
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n, r = mesh.shape[i], mesh.get_local_rank(i)
            sl = out[pl.dim]
            size = (sl.stop - sl.start) // n
            out[pl.dim] = slice(sl.start + r * size, sl.start + (r + 1) * size)
    return tuple(out)


def local_block(x, mesh, placements):
    """The block of the whole tensor (or array) ``x`` that this rank holds
    under ``placements``: each ``Shard(d)`` on a mesh axis of size n cuts
    dimension ``d`` into n equal runs and keeps the rank's (a view)."""
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n, r = mesh.shape[i], mesh.get_local_rank(i)
            size = x.shape[pl.dim] // n
            x = x[(slice(None),) * pl.dim + (slice(r * size, (r + 1) * size),)]
    return x


def paired_leaves(tree: Any, other: Any) -> list:
    """``other``'s entries at ``tree``'s leaves, in :func:`tree_leaves`'
    order (``other`` may hold tuples at a leaf: a spec tree)."""
    out: list = []
    _pair_into(tree, other, out)
    return out


def _pair_into(t, o, out: list) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _pair_into(t[k], o[k], out)
    elif isinstance(t, (list, tuple)):
        for a, b in zip(t, o):
            _pair_into(a, b, out)
    else:
        out.append(o)


def map_placed(fn: Callable, tree: Any) -> Any:
    """``fn`` over the tensors of a state tree (dicts, lists, tuples, named
    tuples, dataclasses); a dataclass field whose metadata says ``static``
    or ``host`` (a ring's depth, its host-side heads) is kept as it is,
    and so is every other value."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_placed(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_placed(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_placed(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_placed(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if not (f.metadata.get("static") or f.metadata.get("host"))})
    return tree


def place_chains(tree: Any, mesh, axis, specs: Any = None) -> Any:
    """A rank's block placed: every tensor of ``tree`` (this rank's block of
    chains on its leading axis) becomes a ``DTensor`` over ``mesh`` sharded
    on ``axis`` and replicated on the other axes; with ``specs`` (a tree of
    one chain's specs beside ``tree``: a 2-D bank, each leaf already the
    rank's :func:`local_block`) also split as its spec says.  ``axis``
    None: the chains replicated (a bank of one trained on the model axis,
    :func:`~repro_torch.launch.steps.place_params`).  No collective runs."""
    from torch.distributed.tensor import DTensor

    if specs is not None:
        return tree_map(lambda t, s: DTensor.from_local(
            t, mesh, chain_placements(mesh, axis, spec=s), run_check=False), tree, specs)
    placements = chain_placements(mesh, axis)
    return map_placed(lambda t: DTensor.from_local(t, mesh, placements,
                                                   run_check=False), tree)


def local(tree: Any) -> Any:
    """Every ``DTensor`` of ``tree`` as this rank's local tensor (a view:
    in-place updates reach the placed tensor); other values unchanged."""
    return map_placed(lambda t: t.to_local() if is_placed(t) else t, tree)


def place_like(tree: Any, like: Any) -> Any:
    """Each tensor of ``tree`` (a rank's local blocks) placed as the leaf of
    ``like`` beside it is; where that one is a plain tensor, as it is."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t, ref: DTensor.from_local(
        t, ref.device_mesh, ref.placements, run_check=False) if is_placed(ref) else t,
        tree, like)


def gather_chains(tree: Any) -> Any:
    """Every ``DTensor`` of ``tree`` gathered whole onto every rank, leaf by
    leaf: one all-gather a leaf and split mesh axis, the last axis first,
    so a 2-D bank comes back whole too; other values unchanged.  Through
    :func:`all_gather` rather than DTensor's ``full_tensor``, which crashes
    on a gloo world over a card's tensors."""
    def whole(t):
        if not is_placed(t):
            return t
        x, mesh = t.to_local(), t.device_mesh
        for i in reversed(range(mesh.ndim)):
            pl = t.placements[i]
            if pl.is_shard() and mesh.shape[i] > 1:
                x = all_gather(x, mesh.get_group(i), pl.dim)
        return x

    return map_placed(whole, tree)


def map_local(fn: Callable, tree: Any) -> Any:
    """``fn`` over the tensors of ``tree``, applied to a ``DTensor``'s local
    rows and placed back as it was placed (``fn`` keeps the placed axis)."""
    from torch.distributed.tensor import DTensor

    def one(t):
        if not is_placed(t):
            return fn(t)
        return DTensor.from_local(fn(t.to_local()), t.device_mesh, t.placements,
                                  run_check=False)

    return map_placed(one, tree)


def gather_rows(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """All-gather one local block ``x`` (this rank's chains on axis
    ``dim``) over the mesh axis ``axis``; every rank gets the whole, in
    chain order, on ``x``'s device (a host tensor is moved to the mesh's
    device type for the collective and back).  One ``all_gather`` over the
    axis' group (none on an axis of one rank), not DTensor's
    ``full_tensor``: that one crashes on a gloo world over a card's
    tensors (:func:`~repro_torch.launch.mesh.init_world`'s
    ``backend="gloo"``), where ``all_gather`` works."""
    i = mesh_axis(mesh, axis)
    if mesh.shape[i] == 1:
        return x
    t = x if x.device.type == mesh.device_type else x.to(mesh.device_type)
    return all_gather(t, mesh.get_group(i), dim).to(x.device)


def mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for all its others: a barrier over each
    of the mesh's dimension groups in turn, so the ranks of the world off
    the mesh take no part (and pass at once)."""
    import torch.distributed as dist

    if mesh.get_coordinate() is None:
        return
    for i in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(i))


def broadcast_from_origin(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as the mesh's origin rank (every coordinate 0) holds it, on
    every rank of ``mesh``, in place: a broadcast from coordinate 0 over
    each dimension's groups, the last dimension first (the ranks of the
    world off the mesh take no part)."""
    import torch.distributed as dist

    if mesh.get_coordinate() is None:
        return t
    for i in reversed(range(mesh.ndim)):
        group = mesh.get_group(i)
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``group``'s ranks' ``t`` (one shape on every rank) concatenated along
    ``dim`` in rank order."""
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)
