"""ctypes wrappers of the CUDA decode kernels (``csrc/decode_step.cu``).

:func:`decode_step` replaces ``repro.kernels.decode_step.decode_step_2d``
and :func:`paged_decode_step` replaces
``repro.kernels.decode_step.paged_decode_step``.  Both are bound by device
memory bytes — the K/V rows they read — and the source's header says what
the kernels do about it.

The wrappers take CUDA tensors only: they check device, dtype (bfloat16 or
float32), shapes, contiguity and alignment, raise on anything else, launch
on the current stream, allocate the output with ``torch.empty``, update
the caches / pools **in place**, and raise if the launch fails.  Each keeps
a plain launch count (``decode_step.launches``), raised by one per kernel
launch and nowhere else.  The plain versions live in
:mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops` picks one or
the other by the tensors' device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
_WARPS = 8            # kWarps in the source


def _smem_bytes(positions: int, G: int, hd: int) -> int:
    return 4 * (G * positions + _WARPS * G * hd)


def _lib():
    lib = build.load("decode_step")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_step_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                           i, i, f, p]
        lib.decode_step_launch.restype = i
        lib.paged_decode_step_launch.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                                 i, i, i, i, i, i, i, f, p]
        lib.paged_decode_step_launch.restype = i
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_common(q: torch.Tensor, hd: int, G: int, smem: int, what: str) -> None:
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported "
                         f"(bfloat16 or float32)")
    if hd not in _HEAD_DIMS or G not in _GROUPS:
        raise ValueError(f"{what}: head_dim {hd} / group {G} not compiled "
                         f"(head_dim in {_HEAD_DIMS}, group in {_GROUPS})")
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what}: {smem} bytes of scores exceed a block's "
                         f"{_SMEM_LIMIT} bytes of shared memory")


def decode_step(q, k_new, v_new, k_cache, v_cache, valid, slot: int):
    """Fused ring-cache decode step on the card.

    q: (N, KV, G, hd); k_new, v_new: (N, KV, hd); k_cache, v_cache:
    (N, smax, KV, hd), updated in place at ``slot``; valid: (smax,) int32,
    1 = attend, shared by every row; slot: int in [0, smax).  Returns
    ``(o (N, KV, G, hd) in q.dtype, k_cache, v_cache)``.
    """
    N, KV, G, hd = q.shape
    smax = k_cache.shape[1]
    _check_common(q, hd, G, _smem_bytes(smax, G, hd), "decode_step")
    dev, dt = q.device, q.dtype
    _check("q", q, (N, KV, G, hd), dt, dev)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _check(name, t, (N, KV, hd), dt, dev)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(name, t, (N, smax, KV, hd), dt, dev)
    _check("valid", valid, (smax,), torch.int32, dev)
    slot = int(slot)
    if not 0 <= slot < smax:
        raise ValueError(f"slot {slot} outside the {smax}-slot ring")
    build.require_cuda(q, "decode_step")
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().decode_step_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
            valid.data_ptr(), slot, N, smax, KV, G, hd, _DTYPES[dt],
            1.0 / math.sqrt(hd), stream)
    build.check_launch(err, "decode_step")
    decode_step.launches += 1
    return o, k_cache, v_cache


decode_step.launches = 0


def paged_decode_step(q, k_new, v_new, k_pages, v_pages, tables, pos):
    """Fused paged decode step on the card, over one page pool per chain.

    q: (C, S, KV, G, hd); k_new, v_new: (C, S, KV, hd); k_pages, v_pages:
    (C, n_pages, page_size, KV, hd), updated in place at one row per slot,
    ``(tables[s, pos[s] // page_size], pos[s] % page_size)``; tables:
    (S, maxp) int32, shared by the chains; pos: (S,) int32 in
    ``[0, maxp * page_size)``.  A block whose position or page ids fall
    outside the pool writes NaN and stores nothing.  Returns
    ``(o (C, S, KV, G, hd) in q.dtype, k_pages, v_pages)``.
    """
    C, S, KV, G, hd = q.shape
    _, n_pages, ps = k_pages.shape[:3]
    maxp = tables.shape[1] if tables.dim() == 2 else -1
    _check_common(q, hd, G, _smem_bytes(maxp * ps, G, hd), "paged_decode_step")
    dev, dt = q.device, q.dtype
    _check("q", q, (C, S, KV, G, hd), dt, dev)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _check(name, t, (C, S, KV, hd), dt, dev)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(name, t, (C, n_pages, ps, KV, hd), dt, dev)
    _check("tables", tables, (S, maxp), torch.int32, dev)
    _check("pos", pos, (S,), torch.int32, dev)
    build.require_cuda(q, "paged_decode_step")
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().paged_decode_step_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), o.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), C, S, n_pages, ps, maxp, KV,
            G, hd, _DTYPES[dt], 1.0 / math.sqrt(hd), stream)
    build.check_launch(err, "paged_decode_step")
    paged_decode_step.launches += 1
    return o, k_pages, v_pages


paged_decode_step.launches = 0
