"""ctypes wrapper of the CUDA categorical kernel (``csrc/categorical.cu``):
``jax.random.categorical(key, logp, axis=-1)`` bit for bit, in one launch.

``tokens[r] = argmax_v(float32(logp[r, v]) + gumbel(bits(key_r, base_r +
v)))``: under one key row r takes counters ``[r V, (r + 1) V)``
(``rng.categorical``); with a ``(B, 2)`` key table on the card, row r
takes ``[0, V)`` under ``keys[r]`` (``rng.categorical_rows``).  Each row is
split over several blocks, combined in the same launch.  The argmax is
``torch.argmax``'s: the first maximal index, NaN above every number.

The kernel replaces no Pallas kernel: it is what XLA runs for the
reference's ``jax.random.categorical``.  Its plain versions are
:func:`repro_torch.kernels.rng.categorical` and ``categorical_rows`` on the
CPU, which route a CUDA ``logp`` here.

The arrival counters of the combine live in one zeroed int32 buffer a
device, grown when a call has more rows and left zeroed by every launch;
calls on one stream share it (two streams that may overlap would race on
it).  ``categorical.launches`` counts launches and is raised nowhere
else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 256
MIN_CHUNK = 1024  # columns a block at least
TARGET_BLOCKS = 2 * 132  # two blocks an SM of an H100

_COUNTERS: dict = {}  # device -> zeroed int32 arrival counters


def _lib():
    lib = build.load("categorical")
    if not getattr(lib, "_typed", False):
        p, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
        lib.categorical_launch.argtypes = [p, ll, i, p, u, u, p, p, p, p, i, ll, i, p]
        lib.categorical_launch.restype = i
        lib._typed = True
    return lib


def split_of(rows: int, V: int) -> tuple:
    """``(splits, chunk)``: the blocks a row and the columns a block, about
    :data:`TARGET_BLOCKS` blocks in all, at least :data:`MIN_CHUNK` columns
    each."""
    splits = max(1, min(-(-V // MIN_CHUNK), -(-TARGET_BLOCKS // rows)))
    chunk = -(-V // splits)
    return -(-V // chunk), chunk


def _counters(dev, rows: int) -> torch.Tensor:
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < rows:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("categorical: call it once at this batch before "
                               "capturing a CUDA graph of it (its counters are "
                               "made on the first call)")
        buf = _COUNTERS[dev] = torch.zeros(max(rows, 64), dtype=torch.int32, device=dev)
    return buf


def categorical(logp: torch.Tensor, key=None, keys: torch.Tensor | None = None):
    """Sampled indices of ``logp`` ``(B, V)`` (a contiguous CUDA tensor of
    float32, bfloat16 or float16) as int64 ``(B,)``: under one ``key`` (a
    ``(k0, k1)`` pair) at the flat counters, or under ``keys`` ``(B, 2)``
    32-bit words on its device, a key a row at ``[0, V)``."""
    build.require_cuda(logp, "categorical")
    if logp.dim() != 2 or logp.dtype not in DTYPES or not logp.is_contiguous():
        raise ValueError(f"categorical: logp must be contiguous (B, V) of "
                         f"{tuple(DTYPES)}, got {tuple(logp.shape)} {logp.dtype}")
    B, V = logp.shape
    if not 1 <= B <= 65535 or V < 1:
        raise ValueError(f"categorical: {B} rows (1 .. 65535) of {V} columns (>= 1)")
    if (key is None) == (keys is None):
        raise ValueError("categorical: pass one key or a key table")
    if keys is not None and (tuple(keys.shape) != (B, 2) or keys.element_size() != 4
                             or keys.device != logp.device or not keys.is_contiguous()):
        raise ValueError(f"categorical: keys must be contiguous ({B}, 2) 32-bit "
                         f"words on {logp.device}")
    splits, chunk = split_of(B, V)
    dev = logp.device
    tokens = torch.empty(B, dtype=torch.int64, device=dev)
    part_v = torch.empty(B * splits, dtype=torch.float32, device=dev)
    part_i = torch.empty(B * splits, dtype=torch.int64, device=dev)
    counters = _counters(dev, B)
    k0, k1 = (0, 0) if key is None else (int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().categorical_launch(
            logp.data_ptr(), V, B, None if keys is None else keys.data_ptr(), k0, k1,
            tokens.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
            counters.data_ptr(), splits, chunk, DTYPES[logp.dtype], stream)
    build.check_launch(err, "categorical")
    categorical.launches += 1
    return tokens


categorical.launches = 0
