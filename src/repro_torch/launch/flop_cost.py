"""Loop-aware FLOP and byte count of a step, on the ``meta`` device (the
port's counterpart of ``repro.launch.jaxpr_cost``).

:func:`step_cost` runs ``fn(*args)`` under a ``TorchDispatchMode`` that
sees every ATen op the step dispatches — forward and autograd's backward —
and sums:

- **FLOPs** from ``torch.utils.flop_counter``'s formula registry, the
  formulas ``FlopCounterMode`` applies (matmuls, batched matmuls,
  convolutions, the fused attention ops; a loop-free step counts the same
  as ``FlopCounterMode``, which ``tests/test_torch_launch.py`` holds).
  ``matmul_flops`` are the (batched) matrix products alone: ``mm``,
  ``addmm``, ``bmm``, ``baddbmm`` — the reference's ``dot_general``s.  At
  the same (arch, shape) they equal the reference's ``matmul_flops``
  (held at up to 512 tokens, where both packages use plain attention).
- **Bytes**: each op's input and output tensors, summed (view ops, which
  move nothing, are left out).  The reference sums its own op list the
  same way, but XLA and ATen split a step into different ops (XLA fuses
  elementwise chains, ATen runs each), so the two byte counts are not
  held equal: they are each package's own traffic model.

The port's own CUDA kernels are invisible to a dispatch mode (``ctypes``);
they report their formula costs through :mod:`repro_torch.analysis.cost`.
Loops over the sequence are counted as the reference counts a
``lax.scan``: one iteration times the trip count (:func:`repro_torch.
analysis.cost.repeated`) — on ``meta`` only; on a real device they run in
full and every iteration is counted as it runs.  On ``meta`` the same
holds for work that repeats alike: a stack's layers (one period of the
block pattern, ``Model.hidden``) and a step's microbatches
(``train.loop.make_grad_fn``), so a full-size step counts in a fraction
of a second.

Run on ``meta`` tensors (:func:`repro_torch.data.make_specs`, a ``meta``
model and parameters) a step costs no memory and no device; the same mode
counts a real step on the card just as well.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import cost as _cost

_MATMUL = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
           torch.ops.aten.baddbmm}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    matmul_flops: float = 0.0

    def __add__(self, o):
        return Cost(self.flops + o.flops, self.bytes + o.bytes,
                    self.matmul_flops + o.matmul_flops)

    def __mul__(self, k):
        return Cost(self.flops * k, self.bytes * k, self.matmul_flops * k)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _cost.tensor_leaves(tree)
               if torch.is_tensor(t))


class _Counter(TorchDispatchMode):
    """Sums every dispatched op's FLOPs and bytes into ``self.total``."""

    def __init__(self):
        super().__init__()
        self.total = Cost()

    def add(self, flops: float, nbytes: float, matmul: float) -> None:
        self.total = self.total + Cost(flops, nbytes, matmul)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        m = _cost.multiplier()
        packet = func._overloadpacket
        fl = 0.0
        if packet in flop_registry:
            fl = float(flop_registry[packet](*args, **kwargs, out_val=out)) * m
        nbytes = 0.0
        if not getattr(func, "is_view", False):
            nbytes = float(_nbytes(args) + _nbytes(kwargs) + _nbytes(out)) * m
        self.add(fl, nbytes, fl if packet in _MATMUL else 0.0)
        return out


def step_cost(fn, *args) -> Cost:
    """Cost of ``fn(*args)`` (``meta`` tensors, or real ones): its ops'
    FLOPs, matmul FLOPs and bytes, plus the bytes of its inputs and
    outputs once, as the reference adds its jaxpr's in- and outvars."""
    counter = _Counter()
    _cost._ACTIVE.append(counter)
    try:
        with counter:
            out = fn(*args)
    finally:
        _cost._ACTIVE.remove(counter)
    return counter.total + Cost(bytes=float(_nbytes(args) + _nbytes(out)))
