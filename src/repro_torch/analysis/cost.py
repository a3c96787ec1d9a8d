"""The hooks a cost count reads: the counting regions that are active, the
trip-count multiplier of a loop counted once, and the hand-written
kernels' own costs.

:func:`repro_torch.launch.flop_cost.step_cost` opens a counting region (a
``TorchDispatchMode`` that sums each ATen op's FLOPs and bytes) and
registers it here.  Two things such a region cannot see are reported to it
from here:

- **The hand-written kernels.**  They are reached through ``ctypes``
  (:mod:`repro_torch.kernels.ops`), so no ATen op carries their work;
  each kernel op reports its FLOPs and bytes with :func:`record_kernel`,
  from the formulas ``chip_smoke.py`` uses for its bounds (the constants
  below are its own).  A formula that depends on the data (the valid
  slots of a ring, a slot's position) counts every slot it may read: the
  values are not read on the host, and on ``meta`` there are none.
- **Loops counted once.**  The sLSTM (a Python loop over the sequence) and
  the SSD and mLSTM chunk scans (a loop over ``S / 64`` chunks) would take
  minutes on ``meta`` at 32,768 or 524,288 positions.  On ``meta`` they run
  one iteration through :func:`repeated`, which multiplies the counts of
  its ops — and of their backward, through autograd node hooks — by the
  trip count, as the reference's jaxpr walker multiplies a ``lax.scan``
  body by its length.  On a real device the loops run in full.
"""

from __future__ import annotations

import contextlib
import threading

#: counting regions open now (innermost last); each has ``add(flops,
#: bytes, matmul_flops)``
_ACTIVE: list = []
_lock = threading.Lock()
_MULT = [1]  # product of the trip counts of the loops counted once

# 32-bit operations an element, counted from the CUDA sources (chip_smoke.py's
# THREEFRY_OPS, LANGEVIN_OPS and DELAY_OPS): threefry2x32-20 is 20 rounds of
# (add, rotate, xor) plus 12 key-schedule adds; the update adds the counter
# xor, two (shift, convert, mul, add), log, cos, sqrt, 3 muls, 2 fmas and 2
# conversions; a delay draw is two threefry blocks, 2 xors, 3 remainders, a
# multiply, an add and a convert
THREEFRY_OPS = 72
LANGEVIN_OPS = THREEFRY_OPS + 1 + 8 + 3 + 3 + 2 + 2
DELAY_OPS = 2 * THREEFRY_OPS + 8


def multiplier() -> int:
    """The trip-count multiplier the counts are taken at now."""
    return _MULT[0]


def counting() -> bool:
    """True while a counting region is open."""
    return bool(_ACTIVE)


def record_kernel(flops: float, nbytes: float) -> None:
    """Report one hand-written kernel launch's work to every open counting
    region (at the current multiplier)."""
    if not _ACTIVE:
        return
    m = _MULT[0]
    with _lock:
        for region in _ACTIVE:
            region.add(flops * m, nbytes * m, 0.0)


@contextlib.contextmanager
def _times(n: int):
    _MULT[0] *= n
    try:
        yield
    finally:
        _MULT[0] //= n


def _first_seq() -> int:
    """The sequence number the next autograd node will take."""
    import torch

    with torch.enable_grad():
        probe = torch.zeros((), device="meta", requires_grad=True) * 1
    return probe.grad_fn._sequence_nr() + 1


def _hook_backward(outputs, seq0: int, n: int) -> None:
    """Make every autograd node created since ``seq0`` and reachable from
    ``outputs`` run its backward at ``n`` times the multiplier."""
    import torch

    def pre(_grads):
        _MULT[0] *= n

    def post(_grad_inputs, _grad_outputs):
        _MULT[0] //= n

    stack = [t.grad_fn for t in outputs
             if torch.is_tensor(t) and t.grad_fn is not None]
    seen = set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "AccumulateGrad" or node._sequence_nr() < seq0:
            continue
        node.register_prehook(pre)
        node.register_hook(post)
        stack.extend(nxt for nxt, _ in node.next_functions)


def tensor_leaves(tree) -> list:
    """Every leaf of nested dicts, lists and tuples (NamedTuple states
    included), tensors or not."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):  # NamedTuple states included
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree]


def _carried(tree):
    """Floating tensors of ``tree`` that need no gradient, replaced by
    aliases that do (tuples, NamedTuple states included)."""
    import torch

    if isinstance(tree, tuple):
        parts = [_carried(v) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    if torch.is_tensor(tree) and tree.is_floating_point() and not tree.requires_grad:
        return tree.detach().requires_grad_()
    return tree


def _tied(out):
    """``out`` with every output that needs a gradient made to depend on all
    of them (through a zero-weighted sum): whichever output the caller uses,
    the backward runs through each — as it runs through a loop's carried
    state, which the next iteration reads."""
    import torch

    outs = [t for t in tensor_leaves(out) if torch.is_tensor(t) and t.requires_grad]
    if len(outs) < 2:
        return out
    anchor = sum(t.sum() for t in outs) * 0

    def tie(tree):
        if isinstance(tree, list):
            return [tie(v) for v in tree]
        if isinstance(tree, tuple):
            parts = [tie(v) for v in tree]
            return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
        if torch.is_tensor(tree) and tree.requires_grad:
            return tree + anchor
        return tree

    return tie(out)


def repeated(n: int, body, *args):
    """``body(*args)`` run once, its work counted ``n`` times, forward and
    backward (see the module docstring).  Under autograd the floating
    ``args`` (the loop's carry) enter as tensors that need a gradient, as
    every carry after the first does.  For ``meta`` tensors only: the
    caller runs the loop in full on a real device."""
    import torch

    grad = torch.is_grad_enabled()
    seq0 = _first_seq() if grad else 0
    if grad:
        # a loop's first carry (a zero state) needs no gradient, every
        # later one does: count the body as a later iteration
        args = _carried(args)
    with _times(n):
        out = body(*args)
    if grad and n > 1:
        out = _tied(out)
        _hook_backward(tensor_leaves(out), seq0, n)
    return out
