"""The iterate ring buffer and its read models (port of
``repro.core.delay``).

Every committed iterate is copied into a ring holding the last
``tau + 1`` snapshots — one preallocated ``(depth, *leaf)`` tensor per
parameter leaf — and stale reads index into it:

- **consistent** (W-Con, Assumption 2.1): the whole vector from one
  snapshot ``X_{k - tau_k}``;
- **inconsistent** (W-Icon, Assumption 2.3): each coordinate ``i`` from its
  own snapshot ``[X_{s_i}]_i``, ``s_i`` in ``[k - tau_k, k]``.

Where the JAX ring is an immutable pytree rebuilt by every push, the port's
:func:`push` copies into a slot **in place** and returns a ring over the
same tensors with the new head; ``head`` is a host int.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.kernels import ops, ref
from repro_torch.utils import (
    leaf_keys,
    tree_broadcast_leading,
    tree_flatten,
    tree_map,
    tree_unflatten,
)

PyTree = Any


@dataclass
class RingBuffer:
    """History of the last ``depth`` parameter snapshots.

    Attributes:
      history: tree; each leaf has shape ``(depth, *leaf_shape)``.
      head: slot holding the most recent snapshot.
      depth: ``tau + 1``.
    """

    history: PyTree
    head: int
    depth: int


def init_ring(params: PyTree, tau: int) -> RingBuffer:
    """Fill every slot with the initial parameters (delay-0 warm start)."""
    depth = int(tau) + 1
    return RingBuffer(history=tree_broadcast_leading(params, depth), head=0,
                      depth=depth)


class StalenessError(ValueError):
    """A delay schedule demands staler reads than the iterate ring can serve."""


def ring_depths(tree: PyTree) -> list[int]:
    """Depths of every :class:`RingBuffer` inside ``tree`` (e.g. a sampler
    state's transform-chain state)."""
    if isinstance(tree, RingBuffer):
        return [tree.depth]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [d for t in tree for d in ring_depths(t)]
    return []


def check_staleness_fits(max_delay: int, depth: int,
                         context: str = "schedule") -> None:
    """Raise :class:`StalenessError` unless a ring of ``depth`` snapshots can
    serve reads ``max_delay`` commits stale (``read_consistent`` clamps
    silently — running anyway would sample a different, less stale process)."""
    if max_delay >= depth:
        raise StalenessError(
            f"{context} max staleness {max_delay} does not fit the "
            f"iterate ring (depth {depth}, max readable staleness "
            f"{depth - 1}); read_consistent would silently clamp — "
            f"build the sampler with tau >= {max_delay}")


def validate_staleness(max_delay: int, tree: PyTree,
                       context: str = "schedule") -> None:
    """:func:`check_staleness_fits` against every ring inside ``tree``."""
    for depth in ring_depths(tree):
        check_staleness_fits(max_delay, depth, context)


def push(ring: RingBuffer, params: PyTree) -> RingBuffer:
    """Commit a new snapshot into the next slot (a copy, in place)."""
    new_head = (ring.head + 1) % ring.depth
    tree_map(lambda h, x: h[new_head].copy_(x), ring.history, params)
    return RingBuffer(history=ring.history, head=new_head, depth=ring.depth)


def _clip(delay: int, depth: int) -> int:
    return min(max(int(delay), 0), depth - 1)


def read_consistent(ring: RingBuffer, delay: int) -> PyTree:
    """W-Con: the snapshot committed ``delay`` updates ago (clamped to
    depth-1), as views into the ring."""
    slot = (ring.head - _clip(delay, ring.depth)) % ring.depth
    return tree_map(lambda h: h[slot], ring.history)


def sample_coordinate_delays(key, ring: RingBuffer, max_delay: int) -> PyTree:
    """Per-coordinate delays ``s_i ~ U{0..max_delay}`` for the W-Icon read:
    an int32 tree shaped like the parameters, bit for bit the JAX
    package's (leaf ``i`` draws from ``split(key, n_leaves)[i]``)."""
    maxval = _clip(max_delay, ring.depth) + 1
    leaves, treedef = tree_flatten(ring.history)
    return tree_unflatten(treedef, [
        ops.coordinate_delays(k, h[0], maxval).reshape(h.shape[1:])
        for k, h in zip(leaf_keys(key, leaves), leaves)])


def _gather_plain(history, delays, head: int):
    """One leaf's W-Icon read with the plain gather (``torch.gather``)."""
    flat = ref.delay_gather_ref(history.reshape(history.shape[0], -1),
                                delays.reshape(-1), head)
    return flat.reshape(history.shape[1:])


def read_inconsistent(ring: RingBuffer, delays: PyTree) -> PyTree:
    """W-Icon: gather ``x_hat[i] = history[(head - s_i) % depth, i]`` per
    coordinate with the plain gather (the kernel path is
    :func:`repro_torch.kernels.ops.fused_delay_gather`)."""
    return tree_map(lambda h, s: _gather_plain(h, s, ring.head),
                    ring.history, delays)


def read_inconsistent_leafwise(ring: RingBuffer, key, max_delay: int, *,
                               fused: bool) -> PyTree:
    """Draw and read one leaf at a time: the same result as
    :func:`sample_coordinate_delays` then :func:`read_inconsistent`.
    When ``fused``, each leaf is one :func:`ops.wicon_read_leaf` (on a card
    one kernel that draws the delays in registers: no delay tensor at
    all); otherwise only one leaf's delays live at once — 4 bytes a
    coordinate of the largest leaf, not of the whole model."""
    maxval = _clip(max_delay, ring.depth) + 1
    leaves, treedef = tree_flatten(ring.history)
    keys = leaf_keys(key, leaves)
    if fused:
        reads = [ops.wicon_read_leaf(h, k, maxval, ring.head)
                 for k, h in zip(keys, leaves)]
    else:
        reads = [_gather_plain(h, ops.coordinate_delays(k, h[0], maxval), ring.head)
                 for k, h in zip(keys, leaves)]
    return tree_unflatten(treedef, reads)
