"""ctypes wrappers of the CUDA decode kernels (``csrc/decode_step.cuh``,
built as one library a dtype: ``decode_step_bf16.cu``, ``decode_step_f32.cu``).

:func:`decode_step` replaces ``repro.kernels.decode_step.decode_step_2d``
and :func:`paged_decode_step` replaces
``repro.kernels.decode_step.paged_decode_step``.  Both are bound by device
memory bytes — the K/V rows they read — and both are split-KV kernels: the
positions of each (row or slot, KV head) are cut into splits, one block
each, whose K/V tiles stream into shared memory with ``cp.async`` (bf16 on
the tensor cores, f32 on the CUDA cores); the splits are merged in split
order inside the same launch (the source's header says more).

The split plan is pure Python, depends on the shapes alone (so a call's
output is the same bits every time) and is handed to the kernels, which
keep no copy of it:

- :func:`ring_plan` gives a ring of ``smax`` slots ``splits`` chunks of
  ``chunk`` positions (whole tiles of :data:`TILE` positions, at least
  :data:`MIN_CHUNK` positions, at most :data:`MAX_SPLITS` chunks);
- :func:`paged_plan` gives a pool of ``maxp`` pages a slot ``splits``
  splits; a slot at position ``pos`` uses ``pos // ps + 1`` pages, and
  :func:`paged_chunk` is the run of whole pages each split takes (at least
  :func:`paged_min_pages`, :data:`MIN_CHUNK` positions' worth, and at most
  :func:`paged_max_pages`), as the kernel derives it from ``pos``;
- :func:`smem_bytes` is a block's shared memory, which depends on the tile,
  the heads and the pages of a paged chunk, not on the cache length (it
  mirrors the source's layout, so that the wrapper and the CPU tests can
  check it without the card).

The wrappers take CUDA tensors only: they check device, dtype (bfloat16 or
float32), shapes, contiguity and alignment, raise on anything else, launch
on the current stream, allocate the output and an fp32 scratch buffer for
the splits' partial results with ``torch.empty``, update the caches /
pools **in place** and bump their autograd version counters (as the plain
versions' slice assignments do), return the caches / pools they wrote (the
linter's TL005 knows a tensor written in place by the wrapper handing it
back), and raise if the launch fails.  The per-(row, head)
arrival counters live in one zeroed int32 buffer a device of
:data:`MAX_HEADS` counters, made on the first call and never replaced: the
kernel's last block of each (row, head) resets its counter, so every call
finds them zero, and a CUDA graph captured after the first call holds an
address that stays valid.  Calls that share the buffer must not run at the
same time on the card: launches on two streams, or replays of two graphs,
that may overlap would race on the counters.  Each wrapper keeps a plain launch count
(``decode_step.launches``), raised by one per kernel launch and nowhere
else.  The plain versions live in :mod:`repro_torch.kernels.ref`;
:mod:`repro_torch.kernels.ops` picks one or the other by the tensors'
device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 112, 128, 160)
_GROUPS = (1, 2, 3, 4, 5, 7, 8)
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
# kThreads, kTile, kStages and kMaxSplits in the source
THREADS, TILE, STAGES, MAX_SPLITS = 128, 32, 2, 16
MIN_CHUNK = 64  # positions a split takes at least
MAX_HEADS = 1 << 20  # (row or slot, KV head) pairs a call may have


def ring_plan(smax: int) -> tuple:
    """``(splits, chunk)`` of a ``smax``-slot ring: split ``j`` attends over
    positions ``[j * chunk, min((j + 1) * chunk, smax))``.  Chunks are whole
    tiles and at least :data:`MIN_CHUNK` positions (a shorter split spends
    more on its own start and the merge than on its rows), as few as keep
    at most :data:`MAX_SPLITS` of them."""
    if smax < 1:
        raise ValueError(f"a ring needs a slot, got smax={smax}")
    per = max(-(-smax // MAX_SPLITS), MIN_CHUNK)
    chunk = -(-per // TILE) * TILE
    return -(-smax // chunk), chunk


def paged_plan(maxp: int) -> int:
    """Splits per (slot, KV head) of a pool of ``maxp`` pages a slot."""
    if maxp < 1:
        raise ValueError(f"a page table needs a page, got maxp={maxp}")
    return min(MAX_SPLITS, maxp)


def paged_chunk(pos: int, ps: int, splits: int, split: int) -> tuple:
    """The logical positions ``[t0, t1)`` that split ``split`` of a slot at
    position ``pos`` attends over, as the kernel derives them: the slot's
    ``pos // ps + 1`` pages cut into runs of whole pages (the last one up to
    ``pos``); ``t0 == t1`` for a split with nothing to do, which exits at
    once."""
    used = pos // ps + 1
    per = max(-(-used // splits), paged_min_pages(ps))
    pg0, pg1 = split * per, min(split * per + per, used)
    if pg0 >= pg1:
        return pg0 * ps, pg0 * ps
    return pg0 * ps, min(pg1 * ps, pos + 1)


def paged_min_pages(ps: int) -> int:
    """Pages one split of a slot takes at least (:data:`MIN_CHUNK`
    positions' worth, or the slot's every page if it has fewer)."""
    return -(-MIN_CHUNK // ps)


def paged_max_pages(maxp: int, ps: int) -> int:
    """Pages one split of a slot takes at most (its page ids sit in shared
    memory)."""
    return min(maxp, max(-(-maxp // paged_plan(maxp)), paged_min_pages(ps)))


def smem_bytes(G: int, hd: int, elem: int, max_pages: int = 0) -> int:
    """Shared memory of one block in bytes (``smem_layout_bytes`` in the
    source): the double-buffered K/V tiles (reused by the final reduction),
    then q (float32 only), scores, row flags, the splits' (m, l) in the
    merge, (m, l, alpha), a flag and the paged chunk's ``max_pages`` page
    ids.  The reduction keeps ``THREADS // segs`` row groups, ``segs`` the
    16-byte copies of a row (14 or 20 in bf16 at head_dim 112 or 160: no
    divisor of the block's threads)."""
    tiles = STAGES * 2 * TILE * (hd * elem + 16)
    red = (THREADS // (hd * elem // 16)) * G * hd * 4
    q = G * hd if elem == 4 else 0  # bf16 keeps q in registers
    return max(tiles, red) + 4 * (q + G * TILE + STAGES * TILE
                                  + 2 * G * MAX_SPLITS + 3 * G + 4 + max_pages)


_COUNTERS: dict = {}  # device -> MAX_HEADS zeroed int32 arrival counters


def _counters(dev, n: int, what: str) -> torch.Tensor:
    if n > MAX_HEADS:
        raise ValueError(f"{what}: {n} (row, head) pairs exceed the "
                         f"{MAX_HEADS} arrival counters")
    buf = _COUNTERS.get(dev)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what}: call it once before capturing a "
                               "CUDA graph of it (its counters are made "
                               "on the first call)")
        buf = _COUNTERS[dev] = torch.zeros(MAX_HEADS, dtype=torch.int32,
                                           device=dev)
    return buf


def _lib(dtype):
    lib = build.load("decode_step_bf16" if dtype == torch.bfloat16 else "decode_step_f32")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_step_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                           i, i, i, i, i, i, f, p]
        lib.decode_step_launch.restype = i
        lib.paged_decode_step_launch.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                                 i, i, i, i, i, i, i, i, i, i,
                                                 i, i, f, p]
        lib.decode_step_smem_bytes.argtypes = [i, i, i, i]
        lib.decode_step_smem_bytes.restype = ctypes.c_size_t
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


def _check_common(q: torch.Tensor, hd: int, G: int, max_pages: int,
                  what: str) -> None:
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported "
                         f"(bfloat16 or float32)")
    if hd not in _HEAD_DIMS or G not in _GROUPS:
        raise ValueError(f"{what}: head_dim {hd} / group {G} not compiled "
                         f"(head_dim in {_HEAD_DIMS}, group in {_GROUPS})")
    smem = smem_bytes(G, hd, q.element_size(), max_pages)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what}: a block's {smem} bytes of tiles and page "
                         f"ids exceed the {_SMEM_LIMIT} bytes of shared memory")


def decode_step(q, k_new, v_new, k_cache, v_cache, valid, slot: int):
    """Fused ring-cache decode step on the card.

    q: (N, KV, G, hd); k_new, v_new: (N, KV, hd); k_cache, v_cache:
    (N, smax, KV, hd), updated in place at ``slot``; valid: (smax,) int32,
    1 = attend, shared by every row; slot: int in [0, smax).  Returns
    ``(o (N, KV, G, hd) in q.dtype, k_cache, v_cache)``.  The ring is cut
    into :func:`ring_plan` ``(smax)`` splits a (row, KV head).  With no
    position valid at all the output is, as in the plain step, the mean of
    every position's V.
    """
    N, KV, G, hd = q.shape
    smax = k_cache.shape[1]
    _check_common(q, hd, G, 0, "decode_step")
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
    splits, chunk = ring_plan(smax)
    counters = _counters(dev, N * KV, "decode_step")
    o = torch.empty_like(q)
    part = torch.empty(N * KV * splits * G * (hd + 2), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib(dt).decode_step_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
            valid.data_ptr(), part.data_ptr(),
            counters.data_ptr(), slot, N, smax, KV, G, hd,
            _DTYPES[dt], splits, chunk, 1.0 / math.sqrt(hd), stream)
    build.check_launch(err, "decode_step")
    # the new row went in through raw pointers: bump the caches' version
    # counters as the plain step's slice assignment does
    torch.autograd.graph.increment_version(k_cache)
    torch.autograd.graph.increment_version(v_cache)
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
    ``(o (C, S, KV, G, hd) in q.dtype, k_pages, v_pages)``.  Each (slot, KV
    head) runs :func:`paged_plan` ``(maxp)`` splits of whole pages
    (:func:`paged_chunk`).
    """
    C, S, KV, G, hd = q.shape
    _, n_pages, ps = k_pages.shape[:3]
    if tables.dim() != 2:
        raise ValueError(f"tables: expected (S, maxp), got {tuple(tables.shape)}")
    maxp = tables.shape[1]
    splits = paged_plan(maxp)
    max_pages = paged_max_pages(maxp, ps)
    _check_common(q, hd, G, max_pages, "paged_decode_step")
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
    heads = C * S * KV
    counters = _counters(dev, heads, "paged_decode_step")
    part = torch.empty(heads * splits * G * (hd + 2), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib(dt).paged_decode_step_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), o.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), part.data_ptr(),
            counters.data_ptr(), C, S, n_pages, ps, maxp, KV, G, hd,
            _DTYPES[dt], splits, paged_min_pages(ps), max_pages,
            1.0 / math.sqrt(hd), stream)
    build.check_launch(err, "paged_decode_step")
    torch.autograd.graph.increment_version(k_pages)
    torch.autograd.graph.increment_version(v_pages)
    paged_decode_step.launches += 1
    return o, k_pages, v_pages


paged_decode_step.launches = 0
