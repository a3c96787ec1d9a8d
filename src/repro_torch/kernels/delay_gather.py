"""ctypes wrappers of the CUDA W-Icon kernels (``csrc/delay_gather.cu``).

Each takes C chains of one leaf in one launch (C = 1 for a single chain):
rings ``(C, depth, N)``, each chain under its own head, delays and reads
``(C, N)``.

:func:`wicon_read` is the training path's W-Icon read in one launch: each
coordinate's delay ``d_ci`` is drawn in registers, bit for bit
``jax.random.randint`` (``csrc/randint.cuh``), and ``out[c, i] =
history[c, (head_c - d_ci) mod depth, i]`` is read from the ring — no
delay array is allocated or written.  :func:`delay_gather` is the same kernel
with the delays read from an int32 array (any value, the slot taken with
``torch.remainder``'s semantics): the counterpart of
``repro.kernels.delay_gather.delay_gather_1d``.  :func:`coordinate_delays`
draws the delays alone, bit for bit ``jax.random.randint`` (the same
device function), at any counter: a chain's row may pass 2^32 elements,
each drawn at its 64-bit flat index, as JAX draws it.  :func:`wicon_read` and :func:`coordinate_delays` draw
chain c under row c of a device table (:func:`randint_rows` builds the
rows on the host, for each chain's key, maxval and head; the caller copies
every leaf's table to the card at once), and :func:`wicon_read` reads
chain c's head from the same row; :func:`delay_gather` copies the heads to
the card itself.  The source's header says more.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, raise on anything else, allocate the output with
``torch.empty``, launch on the current stream and raise if the launch
fails.  Each keeps a launch count (``wicon_read.launches``,
``delay_gather.launches``, ``coordinate_delays.launches``) raised nowhere
else.  The plain versions are :func:`repro_torch.kernels.ref.wicon_read_ref`,
:func:`~repro_torch.kernels.ref.delay_gather_ref` and
:func:`~repro_torch.kernels.ref.coordinate_delays_ref`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, rng
from repro_torch.utils import to_device

_GATHER_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
ROW_WORDS = 9
#: the longest row the kernels index (``csrc/delay_gather.cu``: 32-bit
#: indices up to 2^32 elements, 64-bit past that)
MAX_ROW = 2**62


def _lib():
    lib = build.load("delay_gather")
    if not getattr(lib, "_typed", False):
        p, i, ull = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
        lib.wicon_read_launch.argtypes = [p, p, ull, i, i, p, i, p]
        lib.wicon_read_launch.restype = i
        lib.delay_gather_launch.argtypes = [p, p, p, ull, i, i, p, i, p]
        lib.delay_gather_launch.restype = i
        lib.coordinate_delays_launch.argtypes = [p, ull, i, p, p]
        lib.coordinate_delays_launch.restype = i
        lib._typed = True
    return lib


def randint_rows(keys, maxvals, heads=None) -> np.ndarray:
    """The ``(C, 9)`` uint32 table rows of the draws: chain c's
    ``jax.random.randint(keys[c], ..., 0, maxvals[c])`` parameters — the
    high and low subkeys, span, mult and the remainder constant's two
    words (``rng.randint_params``, ``rng.fastmod_magic``) — then chain c's
    ring head ``heads[c]`` (0 when not given: the draw alone reads no
    ring)."""
    rows = np.zeros((len(keys), ROW_WORDS), np.uint32)
    for c, (key, maxval) in enumerate(zip(keys, maxvals)):
        if not 1 <= int(maxval) < 2**16:
            raise ValueError(f"maxval {maxval} outside 1 .. 2^16 - 1")
        k_hi, k_lo, span, mult = rng.randint_params(key, maxval)
        magic = rng.fastmod_magic(span)
        rows[c, :8] = (k_hi[0], k_hi[1], k_lo[0], k_lo[1], span, mult,
                       magic & 0xFFFFFFFF, magic >> 32)
    if heads is not None:
        rows[:, 8] = np.asarray(heads, np.int64)
    return rows


def _check_ring(history, what: str):
    build.require_cuda(history, what)
    if history.dim() != 3 or history.dtype not in _GATHER_DTYPES:
        raise ValueError(f"{what}: history must be (C, depth, N) of "
                         f"{_GATHER_DTYPES}, got {tuple(history.shape)} "
                         f"{history.dtype}")
    if not history.is_contiguous():
        raise ValueError(f"{what}: history must be contiguous")
    C, depth, n = history.shape
    if not 1 <= C <= 65535 or not 1 <= n <= MAX_ROW or C * depth * n >= 2**63:
        raise ValueError(f"{what}: {C} chains (1 .. 65535) of {n} elements "
                         f"(1 .. 2^62, and the ring's {C * depth * n} below 2^63)")
    return C, depth, n


def _check_heads(heads, C: int, depth: int, what: str):
    if len(heads) != C or not all(0 <= int(h) < depth for h in heads):
        raise ValueError(f"{what}: heads {list(heads)} for {C} chains (each "
                         f"0 .. {depth - 1})")


def _check_table(table, C: int, device, what: str):
    if (table.device != device or tuple(table.shape) != (C, ROW_WORDS)
            or table.element_size() != 4 or not table.is_contiguous()):
        raise ValueError(f"{what}: table must be ({C}, {ROW_WORDS}) 32-bit "
                         f"words on {device}")


def wicon_read(history: torch.Tensor, table: torch.Tensor, maxvals, heads):
    """The one-pass W-Icon read of C chains in one launch: ``out[c, i] =
    history[c, (head_c - d_ci) mod depth, i]`` with ``d_c =
    jax.random.randint(key_c, (N,), 0, maxvals[c], int32)`` drawn in the
    kernel.

    history: (C, depth, N) contiguous CUDA tensor (float32, bfloat16 or
    int32); table: (C, 9) 32-bit words on its device, :func:`randint_rows`
    of the chains' keys, ``maxvals`` (each 1 .. depth) and ``heads`` (each
    chain's ring slot of its newest snapshot, 0 .. depth - 1); the host
    values are checked here, the table carries them.  Returns out (C, N)
    in history's dtype."""
    C, depth, n = _check_ring(history, "wicon_read")
    _check_table(table, C, history.device, "wicon_read")
    if len(maxvals) != C or not all(1 <= int(m) <= min(depth, 2**16 - 1)
                                    for m in maxvals):
        raise ValueError(f"wicon_read: maxvals {list(maxvals)} for {C} chains "
                         f"(each 1 .. depth {depth})")
    _check_heads(heads, C, depth, "wicon_read")
    out = torch.empty((C, n), dtype=history.dtype, device=history.device)
    with torch.cuda.device(history.device):
        stream = torch.cuda.current_stream(history.device).cuda_stream
        err = _lib().wicon_read_launch(
            history.data_ptr(), out.data_ptr(), n, C, depth,
            table.data_ptr(), history.element_size(), stream)
    build.check_launch(err, "wicon_read")
    wicon_read.launches += 1
    return out


wicon_read.launches = 0


def delay_gather(history: torch.Tensor, delays: torch.Tensor, heads):
    """W-Icon read of C chains in one launch, delays from an array:
    history (C, depth, N) contiguous CUDA tensor (float32, bfloat16 or
    int32); delays (C, N) int32 on its device, any value (the slot is
    ``(heads[c] - delays[c, i]) mod depth``); heads: C host ints, each
    chain's ring slot of its newest snapshot (copied to the card here,
    without stalling the host).  Returns out (C, N) in history's dtype."""
    C, depth, n = _check_ring(history, "delay_gather")
    if (tuple(delays.shape) != (C, n) or delays.dtype != torch.int32
            or delays.device != history.device or not delays.is_contiguous()):
        raise ValueError(f"delay_gather: delays must be contiguous ({C}, {n}) "
                         f"int32 on {history.device}")
    _check_heads(heads, C, depth, "delay_gather")
    heads_dev = to_device(np.asarray(heads, np.int32), history.device)
    out = torch.empty((C, n), dtype=history.dtype, device=history.device)
    with torch.cuda.device(history.device):
        stream = torch.cuda.current_stream(history.device).cuda_stream
        err = _lib().delay_gather_launch(
            history.data_ptr(), delays.data_ptr(), out.data_ptr(), n, C, depth,
            heads_dev.data_ptr(), history.element_size(), stream)
    build.check_launch(err, "delay_gather")
    delay_gather.launches += 1
    return out


delay_gather.launches = 0


def coordinate_delays(table: torch.Tensor, n: int, maxvals) -> torch.Tensor:
    """Per-coordinate delays of C chains in one launch: row c is
    ``jax.random.randint(key_c, (n,), 0, maxvals[c], int32)`` bit for bit.
    table: (C, 9) 32-bit words on a CUDA device, :func:`randint_rows` of
    the chains' keys and ``maxvals`` (each 1 .. 2^16 - 1), n <= 2^62 (past
    2^32 the counter's high word is the index's, as JAX's);
    returns (C, n) int32 there."""
    build.require_cuda(table, "coordinate_delays")
    C = len(maxvals)
    _check_table(table, C, table.device, "coordinate_delays")
    if not 1 <= C <= 65535 or not 1 <= n <= MAX_ROW or C * n >= 2**63 or not all(
            1 <= int(m) < 2**16 for m in maxvals):
        raise ValueError(f"coordinate_delays: {C} chains (1 .. 65535), n {n} "
                         f"(1 .. 2^62), maxvals {list(maxvals)} (1 .. 2^16-1)")
    out = torch.empty((C, n), dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _lib().coordinate_delays_launch(
            out.data_ptr(), n, C, table.data_ptr(), stream)
    build.check_launch(err, "coordinate_delays")
    coordinate_delays.launches += 1
    return out


coordinate_delays.launches = 0
