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
same tensors with the new heads.

:func:`init_ring` makes one chain's ring.  Everything else takes C chains'
rings stacked on a leading axis — leaves ``(C, depth, *leaf)``, the layout
``jax.vmap`` gives the JAX ring; C = 1 for a single chain — and **one head
a chain**: ``head`` is a ``(C,)`` int64 tensor on the host (a 0-d one in
one chain's ring from :func:`init_ring`), as the JAX ring's ``head`` is
``(C,)`` int32 under ``vmap``.  The heads agree while every chain commits;
a commit masked for some chains (a lost commit, a quarantined chain:
``push(..., keep=)``) leaves theirs behind.  Delays, parameters and reads
carry the same leading chain axis, and staleness, keys and delays are
given a chain each.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils import (
    leaf_keys,
    to_device,
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
      history: tree; each leaf has shape ``(depth, *leaf_shape)`` (``(C,
        depth, *leaf_shape)`` stacked).
      head: slot holding each chain's most recent snapshot: a host int64
        tensor, 0-d for one chain's ring, ``(C,)`` stacked (``host``: a
        placed ring keeps its rank's heads on the host, unplaced —
        :func:`repro_torch.utils.place_chains`).
      depth: ``tau + 1`` (static: not a checkpoint leaf).
    """

    history: PyTree
    head: torch.Tensor = field(metadata=dict(host=True))
    depth: int = field(metadata=dict(static=True))


def init_ring(params: PyTree, tau: int) -> RingBuffer:
    """One chain's ring: every slot filled with its initial parameters
    (delay-0 warm start); leaves ``(depth, *leaf)``, head 0."""
    depth = int(tau) + 1
    return RingBuffer(history=tree_broadcast_leading(params, depth),
                      head=torch.zeros((), dtype=torch.int64), depth=depth)


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


def heads(ring: RingBuffer) -> list:
    """Every chain's head of a chain-stacked ring, as host ints (one a
    chain of the history's leading axis)."""
    h = ring.head
    if not torch.is_tensor(h) or h.dim() != 1:
        raise TypeError(f"a chain-stacked ring keeps a (C,) head tensor, one "
                        f"slot a chain; got {h!r}")
    n = tree_flatten(ring.history)[0][0].shape[0]
    if h.shape[0] != n:
        raise ValueError(f"{h.shape[0]} heads for {n} chains")
    return h.tolist()


def push(ring: RingBuffer, params: PyTree, keep=None) -> RingBuffer:
    """Commit every chain's new snapshot (``params`` leaves ``(C,
    *leaf)``) into the slot after its head, in place.  With every chain
    kept and the heads equal (the fault-free path) that is one copy a
    leaf; ``keep`` (``(C,)`` bool, host) writes only the kept chains and
    advances only their heads.  The new heads are a new tensor: a caller
    that keeps the old ring can put a chain's head back."""
    old = heads(ring)
    C = len(old)
    kept = list(range(C)) if keep is None else \
        [c for c in range(C) if bool(keep[c])]
    new = list(old)
    for c in kept:
        new[c] = (old[c] + 1) % ring.depth
    if len(kept) == C and len(set(new)) == 1:
        tree_map(lambda h, x: h[:, new[0]].copy_(x), ring.history, params)
    elif kept:
        dev = tree_flatten(ring.history)[0][0].device
        rows = to_device(np.asarray(kept, np.int64), dev)
        slots = to_device(np.asarray([new[c] for c in kept], np.int64), dev)
        tree_map(lambda h, x: h.index_put_((rows, slots), x[rows]),
                 ring.history, params)
    return RingBuffer(history=ring.history, head=torch.tensor(new, dtype=torch.int64),
                      depth=ring.depth)


def _clip(delay: int, depth: int) -> int:
    return min(max(int(delay), 0), depth - 1)


def read_consistent(ring: RingBuffer, delays) -> PyTree:
    """W-Con of every chain: chain c's snapshot committed ``delays[c]``
    updates before its head (clamped to depth-1).  Views into the ring
    when every chain reads the same slot, else one gather a leaf."""
    slots = [(h - _clip(d, ring.depth)) % ring.depth
             for h, d in zip(heads(ring), delays)]
    if len(set(slots)) == 1:
        return tree_map(lambda h: h[:, slots[0]], ring.history)
    dev = tree_flatten(ring.history)[0][0].device
    chains = torch.arange(len(slots), device=dev)
    picked = to_device(np.asarray(slots, np.int64), dev)
    return tree_map(lambda h: h[chains, picked], ring.history)


def _maxvals(max_delays, depth: int) -> list:
    return [_clip(d, depth) + 1 for d in max_delays]


def _keys_by_leaf(keys, leaves) -> list:
    """``keys_by_leaf[i][c]``: leaf ``i``'s key of chain c, the ``i``-th
    split of ``keys[c]`` (as a single JAX chain splits it)."""
    per_chain = [leaf_keys(k, leaves) for k in keys]
    return [[ks[i] for ks in per_chain] for i in range(len(leaves))]


def sample_coordinate_delays(keys, ring: RingBuffer, max_delays) -> PyTree:
    """Per-coordinate delays ``s_i ~ U{0..max_delays[c]}`` of every chain
    for the W-Icon read: an int32 tree shaped like the parameters, ``(C,
    *leaf)``, bit for bit the JAX package's (chain c's leaf ``i`` draws
    from ``split(keys[c], n_leaves)[i]``)."""
    maxvals = _maxvals(max_delays, ring.depth)
    leaves, treedef = tree_flatten(ring.history)
    return tree_unflatten(treedef, [
        ops.coordinate_delays(h[:, 0], ks, maxvals).reshape(h[:, 0].shape)
        for ks, h in zip(_keys_by_leaf(keys, leaves), leaves)])


def read_inconsistent(ring: RingBuffer, delays: PyTree) -> PyTree:
    """W-Icon of every chain: gather ``x_hat[c, i] = history[c, (head_c -
    s_ci) % depth, i]`` per coordinate (``delays``: ``(C, *leaf)`` int32
    leaves)."""
    hs = heads(ring)
    return tree_map(lambda h, s: ops.delay_gather(h, s, hs), ring.history,
                    delays)


def read_inconsistent_leafwise(ring: RingBuffer, keys, max_delays, *,
                               fused: bool) -> PyTree:
    """Draw and read one leaf at a time: the same result as
    :func:`sample_coordinate_delays` then :func:`read_inconsistent`.
    Chain c draws its delays under ``keys[c]`` in ``[0, max_delays[c]]``.
    Each leaf is one launch for every chain on a card: when ``fused``,
    :func:`ops.wicon_read` (the delays drawn in registers: no delay tensor
    at all); otherwise :func:`ops.coordinate_delays` then
    :func:`ops.delay_gather`, so only one leaf's delays live at once — 4
    bytes a coordinate of the largest leaf, not of the whole model.  One
    table of every leaf's draw parameters (and the chains' heads) is
    copied to the card once."""
    hs = heads(ring)
    maxvals = _maxvals(max_delays, ring.depth)
    leaves, treedef = tree_flatten(ring.history)
    keys_by_leaf = _keys_by_leaf(keys, leaves)
    tables = ops.randint_tables(keys_by_leaf, maxvals, hs, leaves[0].device)
    reads = []
    for i, h in enumerate(leaves):
        table = None if tables is None else tables[i]
        if fused:
            reads.append(ops.wicon_read(h, keys_by_leaf[i], maxvals, hs,
                                        table=table))
        else:
            d = ops.coordinate_delays(h[:, 0], keys_by_leaf[i], maxvals, table=table)
            reads.append(ops.delay_gather(h, d, hs))
    return tree_unflatten(treedef, reads)
