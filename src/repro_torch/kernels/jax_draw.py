"""ctypes wrapper of the CUDA draw kernel (``csrc/jax_draw.cu``):
``jax.random.uniform`` / ``normal`` / ``gumbel`` in float32, bit for bit
JAX's on the CPU, in one launch a leaf.

:func:`jax_draw` writes a block of one draw under one key, each element at
its counter in the whole draw (``rng.jax_normal``'s ``start`` and
``block``); :func:`jax_draw_rows` writes R rows, row r under row r of a
``(R, 2)`` key table on the card, each at counters ``[0, n)``
(``jax.vmap`` of a draw over keys).  Both may scale the value by a float32
``c`` (``op="mul"``: ``c * v``; ``op="div"``: ``v / c``), each rounded once,
and cast it to float32, bfloat16 or float16 (nearest even), so a weight's
``(std * normal).astype(dtype)`` is one launch.

The kernel replaces no Pallas kernel: it is what XLA runs for the
reference's ``jax.random`` calls.  Its plain version is
:mod:`repro_torch.kernels.rng`'s host-style path (``rng._draw``), which
the rng functions take on the CPU; on a card they come here
(:func:`repro_torch.kernels.rng.jax_normal`).

The wrappers take CUDA devices only: they check the shapes and the key
table, raise on anything else, allocate the output with ``torch.empty``,
launch on the current stream and raise if the launch fails.
``jax_draw.launches`` counts launches of both (one kernel) and is raised
nowhere else.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build

VALUES = {"uniform": 0, "normal": 1, "gumbel": 2}
OPS = {None: 0, "mul": 1, "div": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_DIMS = 6  # the block's dimensions after merging (csrc/jax_draw.cu)


def _lib():
    lib = build.load("jax_draw")
    if not getattr(lib, "_typed", False):
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.jax_draw_launch.argtypes = [p, ctypes.c_ulonglong, i, p, u, u, p, i, i,
                                        f, f, f, i, p]
        lib.jax_draw_launch.restype = i
        lib._typed = True
    return lib


def geometry(shape, parts, start: int) -> list:
    """The kernel's geometry words of a block of ``shape``: ``parts`` a
    ``(first, length)`` a dimension (``rng._block_of``), each dimension the
    block takes whole merged into its outer neighbour; then ``[ndim, (length,
    first, stride) a dimension, start]``."""
    dims = []  # (length, first, stride), outermost first
    stride = math.prod(int(n) for n in shape)
    for n, (first, length) in zip(shape, parts):
        stride //= max(int(n), 1)
        if dims and first == 0 and length == n:  # whole: merge into the outer one
            ln, fi, _ = dims[-1]
            dims[-1] = (ln * n, fi * n, stride)
        else:
            dims.append((length, first, stride))
    dims = dims or [(1, 0, 1)]  # a scalar draw
    if len(dims) > MAX_DIMS:
        raise ValueError(f"jax_draw: a block of {tuple(shape)} ({parts}) has "
                         f"{len(dims)} dimensions after merging, over {MAX_DIMS}")
    return [len(dims), *(w for d in dims for w in d), int(start)]


def _launch(out, n: int, rows: int, keys, key, geom, value: str, op, c: float,
            lo: float, span: float) -> None:
    if value not in VALUES or op not in OPS:
        raise ValueError(f"jax_draw: value {value!r} of {tuple(VALUES)}, op {op!r} "
                         f"of {tuple(OPS)}")
    words = (ctypes.c_ulonglong * len(geom))(*geom)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _lib().jax_draw_launch(
            out.data_ptr(), n, rows, None if keys is None else keys.data_ptr(),
            int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF, words,
            VALUES[value], OPS[op], float(np.float32(c)), float(np.float32(lo)),
            float(np.float32(span)), DTYPES[out.dtype], stream)
    build.check_launch(err, "jax_draw")
    jax_draw.launches += 1


def _check_dtype(dtype) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"jax_draw: dtype {dtype} not one of {tuple(DTYPES)}")


def jax_draw(key, shape, parts, value: str, device, *, start: int = 0, op=None,
             c: float = 1.0, lo: float = 0.0, span: float = 1.0,
             dtype=torch.float32) -> torch.Tensor:
    """The block ``parts`` (a ``(first, length)`` a dimension of ``shape``)
    of the draw of ``shape`` under ``key`` (a ``(k0, k1)`` pair), each
    element at counter ``start`` + its flat index in ``shape``, on the CUDA
    ``device``: ``value`` one of ``uniform`` (``lo``, ``span``: float32
    minval and maxval - minval), ``normal``, ``gumbel``; then ``op`` with
    ``c``; then cast to ``dtype``.  Returns the block's shape."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"jax_draw launches a CUDA kernel; got device {device} "
                         "(the plain version is rng._draw)")
    _check_dtype(dtype)
    out_shape = tuple(length for _, length in parts)
    n = math.prod(out_shape)
    if start < 0 or start + math.prod(int(s) for s in shape) > 2**64:
        raise ValueError(f"jax_draw: counters from {start} of {tuple(shape)} pass 2^64")
    out = torch.empty(out_shape, dtype=dtype, device=device)
    if n:
        _launch(out, n, 1, None, key, geometry(shape, parts, start), value, op, c, lo,
                span)
    return out


def jax_draw_rows(keys: torch.Tensor, n: int, value: str, *, op=None, c: float = 1.0,
                  lo: float = 0.0, span: float = 1.0,
                  dtype=torch.float32) -> torch.Tensor:
    """R rows of ``n`` elements in one launch, row r the draw under
    ``keys[r]`` at counters ``[0, n)``: keys ``(R, 2)`` 32-bit words on a
    CUDA device (1 <= R <= 65535); ``value``, ``op``, ``c``, ``lo``,
    ``span`` and ``dtype`` as :func:`jax_draw`'s.  Returns ``(R, n)``."""
    build.require_cuda(keys, "jax_draw_rows")
    _check_dtype(dtype)
    R = keys.shape[0]
    if (keys.dim() != 2 or keys.shape[1] != 2 or keys.element_size() != 4
            or not keys.is_contiguous() or not 1 <= R <= 65535):
        raise ValueError(f"jax_draw_rows: keys must be contiguous (R, 2) 32-bit "
                         f"words, 1 <= R <= 65535; got {tuple(keys.shape)} {keys.dtype}")
    out = torch.empty((R, n), dtype=dtype, device=keys.device)
    if n:
        _launch(out, n, R, keys, (0, 0), geometry((n,), [(0, n)], 0), value, op, c, lo,
                span)
    return out


jax_draw.launches = 0
