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
import functools
import math

import torch

from repro_torch.kernels import build

VALUES = {"uniform": 0, "normal": 1, "gumbel": 2}
OPS = {None: 0, "mul": 1, "div": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_DIMS = 6  # the block's dimensions after merging (csrc/jax_draw.cu)
THREADS, PER = 256, 8  # a block's threads, a group's elements (csrc/jax_draw.cu)


def _lib():
    lib = build.load("jax_draw")
    if not getattr(lib, "_typed", False):
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.jax_draw_launch.argtypes = [p, i, p, u, u, p, i, i, f, f, f, i, i, p]
        lib.jax_draw_launch.restype = i
        lib.jax_draw_shape.argtypes = [p, p]
        lib.jax_draw_shape.restype = None
        lib._typed = True
    return lib


def kernel_shape() -> tuple:
    """``(threads, per)`` as the built kernel has them (the card's tests
    hold :data:`THREADS` and :data:`PER` to them)."""
    t, p = ctypes.c_int(), ctypes.c_int()
    _lib().jax_draw_shape(ctypes.byref(t), ctypes.byref(p))
    return t.value, p.value


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


def plan(geom) -> dict:
    """The kernel's launch plan of one row (its ``make_plan``), shape only:
    the lines of the innermost dimension (``L`` elements, ``G`` groups of
    :data:`PER` a line), the outer dimensions' ``(length, stride)``, the
    first counter ``base``, the groups a row and the row's elements ``n``;
    ``wide`` when the block's last counter reaches 2^32 (64-bit counters,
    else 32-bit)."""
    ndim, start = geom[0], geom[-1]
    dims = [tuple(geom[1 + 3 * d:4 + 3 * d]) for d in range(ndim)]
    L = dims[-1][0]
    G = -(-L // PER)
    outer = [(ln, st) for ln, _, st in dims[:-1]]
    last = start + sum((fi + ln - 1) * st for ln, fi, st in dims)
    return {"L": L, "G": G, "outer": outer,
            "base": start + sum(fi * st for _, fi, st in dims),
            "groups": G * math.prod(ln for ln, _ in outer),
            "n": math.prod(ln for ln, _, _ in dims), "wide": last >= 2**32}


def grid(p: dict, rows: int, wave: int) -> tuple:
    """The launcher's grid ``(x, rows)`` for ``rows`` rows of plan ``p`` on
    a card that holds ``wave`` blocks at once: one block a :data:`THREADS`
    groups, at most one wave over the rows (each block loops)."""
    if not 1 <= rows <= 65535:
        raise ValueError(f"jax_draw: {rows} rows, not 1 .. 65535")
    return min(-(-p["groups"] // THREADS), -(-wave // rows)), rows


def group_elements(p: dict, g):
    """Where the kernel's groups ``g`` (an int array) write: each group's
    first element's offset in the row, its first counter and its length
    (:data:`PER`, or the rest of a ragged line), as the kernel computes
    them (in the 32-bit path by its divisions by magic numbers)."""
    import numpy as np

    g = np.asarray(g, np.int64)
    if not p["outer"]:
        o, inner, c = np.zeros_like(g), g * PER, p["base"] + g * PER
    else:
        o = _div(g, p["G"], p["wide"])
        inner = (g - o * p["G"]) * PER
        c, q = np.full_like(g, p["base"]), o
        for ln, st in reversed(p["outer"][1:]):
            up = _div(q, ln, p["wide"])
            c, q = c + (q - up * ln) * st, up
        c = c + q * p["outer"][0][1] + inner
    return o * p["L"] + inner, c, np.minimum(PER, p["L"] - inner)


def magic(d: int) -> tuple:
    """``(m, shift)`` of the kernel's 32-bit division by ``d`` (n, d < 2^31:
    ``(n * m) >> (32 + shift)``; ``m = 0``: d = 1)."""
    if d == 1:
        return 0, 0
    ceil_log2 = (d - 1).bit_length()
    return -(-(1 << (31 + ceil_log2)) // d), ceil_log2 - 1


def _div(n, d: int, wide: bool):
    if wide or d == 1:
        return n // d
    m, shift = magic(d)
    return ((n * m) >> 32) >> shift


def vector_ok(ptr: int, rows: int, p: dict) -> bool:
    """Whether a row's full groups may store 16-byte vectors: the output at
    ``ptr`` aligned, and every row and line starting at a multiple of
    :data:`PER` elements."""
    return (ptr % 16 == 0 and (rows == 1 or p["n"] % PER == 0)
            and (not p["outer"] or p["L"] % PER == 0))


@functools.lru_cache(maxsize=4096)
def _prepared(shape: tuple, parts: tuple, start: int) -> tuple:
    """A draw's block as the launcher takes it, built once a shape (draws
    repeat their shapes): the geometry as ctypes words, and the plan."""
    geom = geometry(shape, parts, start)
    return (ctypes.c_ulonglong * len(geom))(*geom), plan(geom)


def _launch(out, rows: int, keys, k0: int, k1: int, prepared, value: str, op, c: float,
            lo: float, span: float) -> None:
    words, p = prepared
    try:
        v, o = VALUES[value], OPS[op]
    except KeyError:
        raise ValueError(f"jax_draw: value {value!r} of {tuple(VALUES)}, op {op!r} "
                         f"of {tuple(OPS)}") from None
    ptr = out.data_ptr()
    args = (ptr, rows, None if keys is None else keys.data_ptr(), k0, k1, words, v, o, c,
            lo, span, DTYPES[out.dtype], int(vector_ok(ptr, rows, p)))
    idx = out.get_device()
    if idx == torch.cuda.current_device():  # no device switch: the common case
        err = _lib().jax_draw_launch(*args, build.raw_stream(idx))
    else:
        with torch.cuda.device(idx):
            err = _lib().jax_draw_launch(*args, build.raw_stream(idx))
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
    device = device if isinstance(device, torch.device) else torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"jax_draw launches a CUDA kernel; got device {device} "
                         "(the plain version is rng._draw)")
    _check_dtype(dtype)
    shape = tuple(shape)
    parts = tuple(parts)
    out_shape = tuple(length for _, length in parts)
    n = math.prod(out_shape)
    if start < 0 or start + math.prod(shape) > 2**64:
        raise ValueError(f"jax_draw: counters from {start} of {shape} pass 2^64")
    out = torch.empty(out_shape, dtype=dtype, device=device)
    if n:
        _launch(out, 1, None, int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF,
                _prepared(shape, parts, start), value, op, c, lo, span)
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
        _launch(out, R, keys, 0, 0, _prepared((n,), ((0, n),), 0), value, op, c, lo, span)
    return out


jax_draw.launches = 0
