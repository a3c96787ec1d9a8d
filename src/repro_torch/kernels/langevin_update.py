"""ctypes wrapper of the CUDA Langevin-update kernel
(``csrc/langevin_update.cu``).

:func:`langevin_update` replaces
``repro.kernels.langevin_update.langevin_update_2d``: the fused SGLD commit
``x <- x - gamma*g + scale*xi`` with the threefry/Box-Muller noise made in
the kernel, **in place** on ``x``.  It takes one leaf of C chains, x and g
``(C, ...)`` in their own dtype (bfloat16 or float32) — no padding and no
float32 copy, which the JAX wrapper makes — in one launch for every chain
(C = 1 for a single chain), chain c under row c ``(s0, s1, gamma, scale,
skip)`` of a device table (:func:`chain_rows` builds the rows on the
host; the caller copies every leaf's table to the card at once).  A
chain whose row says skip is neither read nor written (a lost commit, a
quarantined chain); an optional ``(C,)`` int32 output is set for every
chain any of whose updated elements is NaN or Inf.  It is bound by
integer operations (one threefry block per element); the source's header
says more.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, raises on anything else, launches on the current stream and
raises if the launch fails.  It bumps the autograd version counter of
every tensor the kernel writes (x, flags), as the plain version's torch
in-place ops do, and returns ``x``: the linter's TL005 knows a tensor
written in place by the wrapper handing it back, so an in-place wrapper
returns what it wrote.  ``langevin_update.launches`` counts launches
and is raised nowhere else.  The plain version is
:func:`repro_torch.kernels.ref.langevin_update_ref`.
"""

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
    # the kernel wrote through raw pointers: bump the version counters as a
    # torch in-place op does, so a graph that saved x refuses it in backward
    torch.autograd.graph.increment_version(x)
    if flags is not None:
        torch.autograd.graph.increment_version(flags)
    langevin_update.launches += 1
    return x


langevin_update.launches = 0
