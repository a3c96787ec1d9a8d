"""ctypes wrapper of the CUDA Langevin-update kernel
(``csrc/langevin_update.cu``).

:func:`langevin_update` replaces
``repro.kernels.langevin_update.langevin_update_2d``: the fused SGLD commit
``x <- x - gamma*g + scale*xi`` with the threefry/Box-Muller noise made in
the kernel, **in place** on ``x``.  It takes one leaf of any shape in its
own dtype (bfloat16 or float32) — no padding and no float32 copy, which
the JAX wrapper makes.  It is bound by integer operations (one threefry
block per element); the source's header says more.

The wrapper takes CUDA tensors only: it checks device, dtype, size and
contiguity, raises on anything else, launches on the current stream and
raises if the launch fails.  ``langevin_update.launches`` counts launches
and is raised nowhere else.  The plain version is
:func:`repro_torch.kernels.ref.langevin_update_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("langevin_update")
    if not getattr(lib, "_typed", False):
        p, u, f = ctypes.c_void_p, ctypes.c_uint, ctypes.c_float
        lib.langevin_update_launch.argtypes = [p, p, ctypes.c_ulonglong, u, u,
                                               f, f, ctypes.c_int, p]
        lib.langevin_update_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def langevin_update(x: torch.Tensor, g: torch.Tensor, seed, gamma, scale):
    """x <- x - gamma*g + scale*xi on the card, in place; returns x.

    x, g: contiguous CUDA tensors of one dtype (bfloat16 or float32) and
    the same number of elements, at most 2^32; seed: ``(s0, s1)`` uint32
    ints; gamma, scale: float32 scalars."""
    build.require_cuda(x, "langevin_update")
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise ValueError(f"langevin_update: dtypes {x.dtype}/{g.dtype} (one of "
                         f"bfloat16, float32 for both)")
    if g.device != x.device or g.numel() != x.numel():
        raise ValueError("langevin_update: g must match x's device and size")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("langevin_update: x and g must be contiguous")
    n = x.numel()
    if not 1 <= n <= 2**32:
        raise ValueError(f"langevin_update: {n} elements (1 .. 2^32)")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().langevin_update_launch(
            x.data_ptr(), g.data_ptr(), n, int(seed[0]), int(seed[1]),
            float(gamma), float(scale), _DTYPES[x.dtype], stream)
    build.check_launch(err, "langevin_update")
    langevin_update.launches += 1
    return x


langevin_update.launches = 0
