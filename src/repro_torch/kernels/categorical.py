"""ctypes wrapper of the CUDA categorical kernel (``csrc/categorical.cu``):
``jax.random.categorical(key, logp, axis=-1)`` bit for bit, in one launch.

``tokens[r] = argmax_v(float32(logp[r, v]) + gumbel(bits(key_r, base_r +
v)))``: under one key row r takes counters ``[r V, (r + 1) V)``
(``rng.categorical``); with a ``(B, 2)`` key table on the card, row r
takes ``[0, V)`` under ``keys[r]`` (``rng.categorical_rows``).  Each row is
split over blocks of :data:`THREADS` threads, :data:`COLS` columns each,
combined in the same launch by one 64-bit ``atomicMax`` a block on an
ordered key (:func:`ordered_keys`).  The argmax is ``torch.argmax``'s: the
first maximal index, NaN above every number.

The kernel replaces no Pallas kernel: it is what XLA runs for the
reference's ``jax.random.categorical``.  Its plain versions are
:func:`repro_torch.kernels.rng.categorical` and ``categorical_rows`` on the
CPU, which route a CUDA ``logp`` here.

The combine's words (a 64-bit key a row) and arrival counters live in one
zeroed buffer a device, grown when a call has more rows and left zeroed by
every launch; calls on one stream share it (two streams that may overlap
would race on it).  ``categorical.launches`` counts launches and is raised
nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS, COLS = 128, 8  # a block's threads, a thread's columns (csrc/categorical.cu)
SPAN = THREADS * COLS
MAX_V = 2**31

_SCRATCH: dict = {}  # device -> zeroed int64: a word a row, then the counters


def _lib():
    lib = build.load("categorical")
    if not getattr(lib, "_typed", False):
        p, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
        lib.categorical_launch.argtypes = [p, ll, i, p, u, u, p, p, p, i, p]
        lib.categorical_launch.restype = i
        lib.categorical_shape.argtypes = [p, p]
        lib.categorical_shape.restype = None
        lib._typed = True
    return lib


def kernel_shape() -> tuple:
    """``(threads, cols)`` as the built kernel has them (the card's tests
    hold :data:`THREADS` and :data:`COLS` to them)."""
    t, c = ctypes.c_int(), ctypes.c_int()
    _lib().categorical_shape(ctypes.byref(t), ctypes.byref(c))
    return t.value, c.value


def plan(rows: int, V: int) -> tuple:
    """The launch's grid ``(blocks a row, rows)``: one block a span of
    :data:`SPAN` columns."""
    if not 1 <= rows <= 65535:
        raise ValueError(f"categorical: {rows} rows, not 1 .. 65535")
    return -(-V // SPAN), rows


def peel_of(row_ptr: int, elsize: int, V: int) -> int:
    """A row's columns before its first 16-byte boundary (read one each)."""
    return min(((16 - row_ptr % 16) % 16) // elsize, V)


def thread_columns(V: int, peel: int, block: int, thread: int) -> list:
    """The columns thread ``thread`` of block ``block`` takes in a row, as
    the kernel assigns them: a peeled column (block 0), then up to
    :data:`COLS` consecutive ones after the peel."""
    cols = [thread] if block == 0 and thread < peel else []
    v0 = peel + (block * THREADS + thread) * COLS
    return cols + list(range(v0, min(v0 + COLS, V)))


def ordered_keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ordered keys of the float32 values ``x`` ``(..., V)``
    (column v's value, then ``0xFFFFFFFF - v``), as int64: the unsigned
    key less 2^63, so that int64 order is the kernel's unsigned order.  The
    largest key's column is ``torch.argmax``'s choice."""
    b = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, torch.zeros_like(b), b)  # -0.0 as +0.0
    b = torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)
    b = torch.where(torch.isnan(x), torch.full_like(b, 0xFFFFFFFF), b)
    v = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    return ((b - 2**31) << 32) | (0xFFFFFFFF - v)


def argmax_of_keys(keys: torch.Tensor) -> torch.Tensor:
    """The column of each row's largest :func:`ordered_keys` key."""
    return 0xFFFFFFFF - (keys.max(dim=-1).values & 0xFFFFFFFF)


def _scratch(dev, rows: int) -> torch.Tensor:
    buf = _SCRATCH.get(dev)
    if buf is None or buf.numel() < 2 * rows:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("categorical: call it once at this batch before "
                               "capturing a CUDA graph of it (its words are made "
                               "on the first call)")
        buf = _SCRATCH[dev] = torch.zeros(2 * max(rows, 64), dtype=torch.int64, device=dev)
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
    if not 1 <= B <= 65535 or not 1 <= V <= MAX_V:
        raise ValueError(f"categorical: {B} rows (1 .. 65535) of {V} columns "
                         f"(1 .. 2^31)")
    if (key is None) == (keys is None):
        raise ValueError("categorical: pass one key or a key table")
    dev = logp.device
    if keys is not None and (tuple(keys.shape) != (B, 2) or keys.element_size() != 4
                             or keys.device != dev or not keys.is_contiguous()):
        raise ValueError(f"categorical: keys must be contiguous ({B}, 2) 32-bit "
                         f"words on {dev}")
    tokens = torch.empty(B, dtype=torch.int64, device=dev)
    buf = _scratch(dev, B)
    words = buf.data_ptr()
    k0, k1 = (0, 0) if key is None else (int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF)
    args = (logp.data_ptr(), V, B, None if keys is None else keys.data_ptr(), k0, k1,
            tokens.data_ptr(), words, words + 8 * B, DTYPES[logp.dtype])
    idx = logp.get_device()
    if idx == torch.cuda.current_device():  # no device switch: the common case
        err = _lib().categorical_launch(*args, build.raw_stream(idx))
    else:
        with torch.cuda.device(idx):
            err = _lib().categorical_launch(*args, build.raw_stream(idx))
    build.check_launch(err, "categorical")
    categorical.launches += 1
    return tokens


categorical.launches = 0
