"""TL005 fixture: ``repro_torch.kernels.langevin_update`` as it was before
the launch bumped autograd's version counter — the module verbatim below
this docstring.  The launch writes ``x`` in place through its data_ptr()
and hands it back: TL005 fires on the launch for ``x`` alone (``g`` and
``table`` are read, ``flags`` is not handed back)."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("langevin_update")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.langevin_update_launch.argtypes = [p, p, ctypes.c_ulonglong,
                                               ctypes.c_int, p, p, ctypes.c_int, p]
        lib.langevin_update_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


ROW_WORDS = 5


def chain_rows(seeds, gammas, scales, skip=None) -> np.ndarray:
    """The ``(C, 5)`` uint32 table rows of :func:`langevin_update`: chain
    c's seed ``(s0, s1)``, gamma and scale as float32 bits, then 1 where
    ``skip[c]`` (C host bools, optional: none skipped) else 0."""
    rows = np.zeros((len(seeds), ROW_WORDS), np.uint32)
    rows[:, :2] = np.asarray(seeds, np.uint64).reshape(-1, 2) & 0xFFFFFFFF
    rows[:, 2] = np.asarray(gammas, np.float32).view(np.uint32)
    rows[:, 3] = np.asarray(scales, np.float32).view(np.uint32)
    if skip is not None:
        rows[:, 4] = np.asarray(skip, bool)
    return rows


def langevin_update(x: torch.Tensor, g: torch.Tensor, table: torch.Tensor,
                    flags: torch.Tensor | None = None):
    """x[c] <- x[c] - gamma_c*g[c] + scale_c*xi_c for every chain c in one
    launch, in place; returns x.

    x, g: contiguous ``(C, ...)`` CUDA tensors of one dtype (bfloat16 or
    float32) and shape, at most 2^32 elements a chain; table: ``(C, 5)``
    32-bit words on x's device, row c :func:`chain_rows`' row c (a chain
    whose skip word is set keeps its row of x bitwise).  Chain c's noise
    counter is its element's index within the chain.  flags (optional):
    ``(C,)`` int32 on x's device, set to 1 for every chain any of whose
    written elements is NaN or Inf and left alone otherwise (one write a
    block at most), so one zeroed buffer collects a whole commit's
    leaves."""
    build.require_cuda(x, "langevin_update")
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise ValueError(f"langevin_update: dtypes {x.dtype}/{g.dtype} (one of "
                         "bfloat16, float32 for both)")
    if x.dim() < 1 or g.shape != x.shape or g.device != x.device:
        raise ValueError("langevin_update: g must match x's (C, ...) shape and "
                         "device")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("langevin_update: x and g must be contiguous")
    C = x.shape[0]
    n = x[0].numel()
    if not 1 <= n <= 2**32 or not 1 <= C <= 65535:
        raise ValueError(f"langevin_update: {C} chains (1 .. 65535) of {n} "
                         "elements (1 .. 2^32)")
    if (table.device != x.device or table.shape != (C, ROW_WORDS)
            or table.element_size() != 4 or not table.is_contiguous()):
        raise ValueError(f"langevin_update: table must be ({C}, {ROW_WORDS}) "
                         f"32-bit words on {x.device}")
    if flags is not None and (flags.device != x.device or flags.shape != (C,)
                              or flags.dtype != torch.int32
                              or not flags.is_contiguous()):
        raise ValueError(f"langevin_update: flags must be contiguous ({C},) "
                         f"int32 on {x.device}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().langevin_update_launch(
            x.data_ptr(), g.data_ptr(), n, C, table.data_ptr(),
            None if flags is None else flags.data_ptr(), _DTYPES[x.dtype], stream)
    build.check_launch(err, "langevin_update")
    langevin_update.launches += 1
    return x


langevin_update.launches = 0
