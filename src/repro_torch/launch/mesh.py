"""Device meshes, and which axes shard what (port of ``repro.launch.mesh``).

The reference builds ``jax`` device meshes of TPU chips; the port builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group, one rank a card (NCCL) or one a CPU process (gloo):

- :func:`init_world` starts the process group: NCCL for ``"cuda"``, gloo
  for ``"cpu"``, over a ``FileStore`` when given one, else from
  ``torchrun``'s environment; ``backend="gloo"`` on ``"cuda"`` makes a
  world of several ranks on one card (NCCL refuses two ranks a card),
  for a check of the collectives' code on one card — a world of several
  cards uses NCCL;
- :func:`make_debug_mesh` / :func:`make_production_mesh` are the
  reference's meshes, with its axis names and shapes;
- :func:`batch_axes_for` and :func:`fsdp_axes_for` say which axes shard
  the batch and the 2-D parameter layout, and :func:`fsdp_full_axes_for`
  the axes a ``fsdp_full`` step splits its batch and every weight over,
  over a ``DeviceMesh`` or a :class:`MeshShape` (a mesh's shape without
  devices, which the dry run uses);
- :func:`axes_group` is the process group of several mesh axes taken
  together (the world's for a mesh that covers it), for a collective over
  a spec entry that names them all;
- :func:`fake_world` starts a world of any size in one process, for a dry
  run that places a step on ``meta`` tensors.

    torchrun --nproc-per-node 4 my_job.py   # my_job: init_world("cuda"),
                                            # make_debug_mesh(data=4, model=1)
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and their sizes, no devices: ``shape`` maps axis
    name -> size, in mesh order."""

    shape: dict

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def axis_names(mesh) -> tuple:
    """The axis names of a :class:`MeshShape` or a ``DeviceMesh``."""
    if isinstance(mesh.shape, dict):
        return tuple(mesh.shape)
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of a :class:`MeshShape` or a
    ``DeviceMesh``."""
    if isinstance(mesh.shape, dict):
        return mesh.shape[name]
    return mesh.shape[axis_names(mesh).index(name)]


#: the device type of the world :func:`init_world` started (None: none yet,
#: or a process group started elsewhere)
_WORLD_DEVICE: list = [None]


def init_world(device="cuda", store_path=None, *, rank=None, world_size=None,
               backend=None):
    """Start this process's process group, once: NCCL for ``"cuda"`` (the
    rank's card made current: ``LOCAL_RANK``, else the rank modulo the
    cards), gloo for ``"cpu"``.  ``backend="gloo"`` on ``"cuda"`` runs gloo
    over the card's tensors, so that several ranks may share one card
    (NCCL refuses two ranks on one device): it exercises the collectives'
    code on one card, not NVLink; a world of several cards runs NCCL, the
    default.  With ``store_path`` the ranks meet in a
    ``FileStore`` there (``rank`` / ``world_size``, else ``RANK`` /
    ``WORLD_SIZE`` from the environment, else a world of one); without it
    ``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``) is read.  Returns the rank's ``torch.device``."""
    import torch
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"init_world runs on 'cuda' (NCCL) or 'cpu' (gloo), got {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_world('cuda') needs a card; pass 'cpu' for a gloo world")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and kind == "cpu"):
        raise ValueError(f"init_world runs NCCL on 'cuda' or gloo on either, got "
                         f"backend {backend!r} on {device!r}")
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if kind == "cuda":
        local_rank = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    else:
        dev = torch.device("cpu")
    if dist.is_initialized():
        return dev
    _WORLD_DEVICE[0] = kind
    bind = {"device_id": dev} if backend == "nccl" else {}
    if store_path is not None:
        store = dist.FileStore(str(store_path), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                **bind)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size, **bind)
    return dev


def _mesh(shape: tuple, names: tuple):
    """A ``DeviceMesh`` of the first ``prod(shape)`` ranks of the world, on
    the devices :func:`init_world` chose (else NCCL's cards, gloo's CPUs)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_world() (or "
                           "torch.distributed.init_process_group) first")
    n, have = math.prod(shape), dist.get_world_size()
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    device_type = _WORLD_DEVICE[0] or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: ``(data 16, model 16)``, or
    ``(pod 2, data 16, model 16)`` with ``multi_pod``; a ``RuntimeError``
    when the world has fewer ranks."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_debug_mesh(data: int = 2, model: int = 2):
    """A small ``(data, model)`` mesh over the first ``data * model``
    ranks (the reference's CI mesh); a ``RuntimeError`` when the world has
    fewer."""
    return _mesh((data, model), ("data", "model"))


def batch_axes_for(mesh, global_batch: int):
    """Which mesh axes shard the batch: all 'data-like' axes whose product
    divides the batch (long_500k's B=1 falls back to replication)."""
    axes = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    size = math.prod(axis_size(mesh, a) for a in axes) if axes else 1
    if axes and global_batch % size == 0:
        return axes
    return ()


def fsdp_axes_for(mesh):
    """Axes used for the 2-D (fsdp_tp) parameter sharding."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def fsdp_full_axes_for(mesh):
    """The axes a ``fsdp_full`` step splits its batch and each weight over:
    the reference's ``("pod", "data", "model")`` present in the mesh."""
    return tuple(a for a in ("pod", "data", "model") if a in axis_names(mesh))


#: (mesh id, axes) -> (the mesh, this rank's process group over the axes)
_GROUPS: dict = {}


def axes_group(mesh, axes: tuple):
    """The process group of this rank's ranks of ``mesh`` that differ only
    along ``axes`` (a ``DeviceMesh``'s axis names, in mesh order), ranked
    as the axes flatten, the first major: a spec entry ``("data",
    "model")`` splits one dimension over that order.  One axis is its
    mesh group; every axis of a mesh that covers the world is the world.
    Other sets are made once, each rank making only its own group."""
    import torch.distributed as dist

    names = axis_names(mesh)
    axes = tuple(axes)
    if any(a not in names for a in axes) or list(axes) != sorted(axes, key=names.index):
        raise ValueError(f"axes {axes} are not axes of the mesh in its order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    ranks = mesh.mesh
    if len(axes) == len(names) and ranks.numel() == dist.get_world_size() \
            and ranks.flatten().tolist() == list(range(ranks.numel())):
        return dist.group.WORLD
    key = (id(mesh), axes)
    if key not in _GROUPS:
        coord = mesh.get_coordinate()
        idx = tuple(slice(None) if n in axes else coord[i] for i, n in enumerate(names))
        mine = ranks[idx].flatten().tolist()
        if mine != sorted(mine):
            raise ValueError(f"the ranks of {axes} do not rise in mesh order: {mine}")
        _GROUPS[key] = (mesh, dist.new_group(mine, use_local_synchronization=True))
    return _GROUPS[key][1]


@contextlib.contextmanager
def fake_world(world_size: int):
    """A world of ``world_size`` ranks in this process, this process rank 0,
    over torch's fake process group: its collectives return at once
    without moving data (``meta`` tensors go through), so a dry run can
    build rank 0's placed model and step on a mesh of any size.  The group
    is destroyed on exit; a process that already runs one is refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this process; "
                           "the fake world of a dry run needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    _WORLD_DEVICE[0] = "cpu"
    try:
        yield
    finally:
        _GROUPS.clear()
        _WORLD_DEVICE[0] = None
        dist.destroy_process_group()
