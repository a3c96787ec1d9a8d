"""Mesh shapes and which axes shard what (port of ``repro.launch.mesh``).

The reference builds ``jax`` device meshes of 256 or 512 TPU chips; the
port runs on one card and builds no device mesh (a
``torch.distributed.device_mesh.DeviceMesh`` of several cards is ROADMAP
work).  What carries over is the arithmetic over a mesh's *shape*: which
axes shard the batch (:func:`batch_axes_for`) and the 2-D parameter
layout (:func:`fsdp_axes_for`), over any object with ``.shape`` (axis name
-> size) and ``.size`` — :class:`MeshShape`, or a ``DeviceMesh`` wrapped
in one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and their sizes, no devices: ``shape`` maps axis
    name -> size, in mesh order."""

    shape: dict

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def batch_axes_for(mesh, global_batch: int):
    """Which mesh axes shard the batch: all 'data-like' axes whose product
    divides the batch (long_500k's B=1 falls back to replication)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    size = math.prod(mesh.shape[a] for a in axes) if axes else 1
    if axes and global_batch % size == 0:
        return axes
    return ()


def fsdp_axes_for(mesh):
    """Axes used for the 2-D (fsdp_tp) parameter sharding."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
