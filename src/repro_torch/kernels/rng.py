"""Counter-based RNG: threefry2x32, Box-Muller and JAX's key discipline,
without JAX (port of ``repro.kernels.rng`` plus the parts of
``jax.random`` the SGLD path and the paper's potentials draw from).

Two kinds of operand, one code path:

- Python ints, for keys: :func:`split` runs a handful of threefry blocks
  on the host.
- int64 tensors holding 32-bit values, for per-element streams on the CPU
  (PyTorch has no uint32 arithmetic there).  Every add and shift is
  masked back to 32 bits, so the bits equal JAX's ``uint32`` bits.

The long draws (:func:`jax_uniform`, :func:`jax_normal`, a placed leaf's
noise) run the same rounds on int32 tensors that hold the words' bits
(:func:`_threefry32`: adds wrap, right shifts are masked), at half the
bytes.

A key is a ``(k0, k1)`` tuple of 32-bit ints — the two words of a raw JAX
``PRNGKey``.  JAX here runs with ``jax_threefry_partitionable`` (the
default since 0.5), under which ``split(key, n)[i]`` and the random bits of
element ``i`` of a shape are both ``threefry2x32(key, (i >> 32, i &
0xFFFFFFFF))``: the counter is the flat index, split into a high and a low
word (the high word is 0 below 2**32 elements).

The CUDA kernels (``csrc/threefry.cuh``) compute the same functions in
native ``uint32``; the tests hold this module against ``jax.random``.

The float32 draws route by device, as :mod:`repro_torch.kernels.ops`
does: on a card :func:`jax_uniform`, :func:`jax_normal`, :func:`gumbel`,
:func:`normal_rows` and :func:`uniform_rows` are one launch of the draw
kernel (:mod:`~repro_torch.kernels.jax_draw`, ``csrc/jax_draw.cu``), and
:func:`categorical` and :func:`categorical_rows` one launch of the
categorical kernel (:mod:`~repro_torch.kernels.categorical`), with no
fallback; on the CPU they are the plain host-style path below, the
kernels' plain version; on ``meta`` they give shapes as the plain path
does (nothing is drawn).  Any other device raises, and so does a
``DTensor``.  On a card and on ``meta`` each reports its formula cost to
any open count (:func:`repro_torch.analysis.cost.record_kernel`): its
bytes, no FLOPs (:func:`_record`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import categorical as _cat
from repro_torch.kernels import jax_draw as _jd
from repro_torch.utils import is_placed, to_device

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
GOLDEN = 0x9E3779B9  # the second counter word of a Box-Muller pair
TWO_PI = 2.0 * 3.14159265358979  # rounded to float32 where it is used

#: elements per slice of the tensor paths: bounds the int64 temporaries
CHUNK = 1 << 22


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def _word(k):
    """A key word as an int, or an int64 tensor of words (a key a row)."""
    return k.long() & M32 if torch.is_tensor(k) else int(k) & M32


def threefry2x32(key0, key1, x0, x1):
    """20-round threefry2x32 (JAX's schedule) of the counter pair
    ``(x0, x1)`` under the key ``(key0, key1)``.  Operands are ints or
    int64 tensors of 32-bit values (the key words too: a key a row,
    broadcasting against the counters); returns the output pair
    likewise."""
    k0, k1 = _word(key0), _word(key1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & M32
    return x0, x1


# ---------------------------------------------------------------------------
# keys (host ints)
# ---------------------------------------------------------------------------
def PRNGKey(seed: int) -> tuple:
    """The raw key of ``jax.random.PRNGKey(seed)`` for a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return ((seed >> 32) & M32, seed & M32)


def split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` as a list of ``(k0, k1)`` keys (one
    tensor pass on the host past a handful)."""
    if num <= 8:
        return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]
    c = torch.arange(num, dtype=torch.int64)
    x0, x1 = threefry2x32(key[0], key[1], torch.zeros_like(c), c)
    return list(zip(x0.tolist(), x1.tolist()))


def _int64(x) -> torch.Tensor:
    """A tensor, or an array or list of ints, as an int64 tensor (arrays
    copied: they may be read-only)."""
    return x.long() if torch.is_tensor(x) else torch.from_numpy(np.array(x, np.int64))


def fold_in_rows(keys, data) -> torch.Tensor:
    """``vmap(jax.random.fold_in)(keys, data)``: row ``i`` is
    ``fold_in(keys[i], data[i])``.  ``keys`` ``(S, 2)`` and ``data`` ``(S,)``
    (tensors or arrays of 32-bit values); returns ``(S, 2)`` int64 on
    ``keys``' device — one tensor pass, not S host loops."""
    keys = _int64(keys).reshape(-1, 2)
    data = _int64(data).to(keys.device) & M32
    x0, x1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(data), data)
    return torch.stack([x0, x1], dim=1)


def as_key(key) -> tuple:
    """A PRNG key as the ``(k0, k1)`` pair of ints: a pair, or a ``(2,)``
    uint32 array such as ``np.asarray(jax.random.PRNGKey(s))``; an int is
    read as ``PRNGKey(int)``.  A ``torch.Generator`` is refused: the key
    contract is the JAX package's (``batch_fn(key)``, a sampling key)."""
    if isinstance(key, torch.Generator):
        raise TypeError("a torch.Generator is not a PRNG key: pass "
                        "rng.PRNGKey(seed), a (2,) uint32 key or an int seed "
                        "(batch_fn now takes one key a batch, split from it "
                        "as the JAX package splits)")
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        return PRNGKey(int(key))
    words = np.asarray(key.cpu() if torch.is_tensor(key) else key).reshape(-1)
    if words.size != 2 or words.dtype.kind not in "iu":
        raise TypeError(f"a PRNG key is two 32-bit words, got {key!r}")
    return int(words[0]) & M32, int(words[1]) & M32


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``: the key
    ``threefry2x32(key, (0, data))``."""
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def key_bits(key) -> tuple:
    """The two uint32 words of a key (``jax.random.key_data``), as ints —
    the seed the fused Langevin kernel takes."""
    return int(key[0]) & M32, int(key[1]) & M32


def leaf_seed(seed, i: int) -> tuple:
    """Seed of leaf ``i`` in the fused update: ``(s0 ^ 0x85EBCA6B·(i+1),
    s1 + i)`` (``repro.kernels.ops.fused_langevin_update``)."""
    return ((seed[0] ^ ((0x85EBCA6B * (i + 1)) & M32)) & M32,
            (seed[1] + i) & M32)


# ---------------------------------------------------------------------------
# per-element streams (int64 tensors)
# ---------------------------------------------------------------------------
def _counters(start: int, stop: int, device) -> torch.Tensor:
    return torch.arange(start, stop, dtype=torch.int64, device=device)


def _check_counter(stop: int) -> None:
    if stop > 2**63:
        raise ValueError(f"{stop} elements exceed the 64-bit counter (an int64 "
                         "tensor holds it)")


def _bits_at(key, counters: torch.Tensor) -> torch.Tensor:
    """``x0 ^ x1`` of ``threefry2x32(key, (c >> 32, c & 0xFFFFFFFF))`` for
    int64 counters ``c``."""
    x0, x1 = threefry2x32(key[0], key[1], counters >> 32, counters & M32)
    return x0 ^ x1


def random_bits(key, n: int, device="cpu", start: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: ``x0 ^ x1`` of
    ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``, as an int64 tensor of
    32-bit values.  ``start`` offsets the counters: elements ``[start,
    start + n)`` of a longer draw under the same key (a block of a
    chain-stacked draw's rows), past 2**32 too."""
    _check_counter(start + n)
    return _bits_at(key, _counters(start, start + n, device))


def _signed(v: int) -> int:
    """A 32-bit value as the int32 that holds its bits."""
    v &= M32
    return v - 2**32 if v >= 2**31 else v


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry32(key0, key1, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """:func:`threefry2x32` on int32 tensors that hold the uint32 words'
    bits: adds wrap as uint32 adds do, and a right shift is masked to a
    logical one — half the bytes of the int64 form, for the long draws.
    The key words may be int64 tensors (a key a row, broadcasting against
    the counters)."""
    k0, k1 = _word(key0), _word(key1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    w = [_word32(k) for k in ks]
    x0 = x0 + w[0]
    x1 = x1 + w[1]
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 += x1
            x1 = _rotl32(x1, r).bitwise_xor_(x0)
        x0 += w[(block + 1) % 3]
        x1 += _word32(ks[(block + 2) % 3] + block + 1)
    return x0, x1


def _word32(k):
    """A 32-bit word (an int, or an int64 tensor of words) as the int32
    that holds its bits."""
    return (k & M32).to(torch.int32) if torch.is_tensor(k) else _signed(k)


def _bits32_at(key, counters: torch.Tensor) -> torch.Tensor:
    """``x0 ^ x1`` of ``threefry2x32(key, (c >> 32, c & 0xFFFFFFFF))`` for
    int64 counters ``c``, as int32 bit patterns: both words go in as the
    int32 that holds their bits."""
    hi = (counters >> 32).to(torch.int32)
    x0, x1 = _threefry32(key[0], key[1], hi, counters.to(torch.int32))  # low 32 bits
    return x0.bitwise_xor_(x1)


def _block_of(shape: tuple, block) -> list:
    """``block`` (a slice a dimension of ``shape``, unit steps; None: the
    whole draw) as ``[(first, length)]`` a dimension."""
    if block is None:
        return [(0, n) for n in shape]
    if len(block) != len(shape):
        raise ValueError(f"block {block} does not name each dimension of {shape}")
    out = []
    for sl, n in zip(block, shape):
        a, b, step = (sl if isinstance(sl, slice) else slice(sl)).indices(n)
        if step != 1:
            raise ValueError(f"block {block} takes unit steps only")
        out.append((a, max(b - a, 0)))
    return out


def _flat_counters(shape: tuple, parts: list, start: int, a: int, b: int,
                   device) -> torch.Tensor:
    """The counters of the block's elements ``[a, b)`` (the block in
    row-major order): each one's flat index in ``shape``, plus ``start``."""
    if all(first == 0 and length == n for (first, length), n in zip(parts, shape)):
        return _counters(start + a, start + b, device)
    j = _counters(a, b, device)
    idx = torch.full_like(j, start)
    stride = 1
    for d in reversed(range(len(shape))):
        first, length = parts[d]
        idx += (j % length + first) * stride
        j = j // length
        stride *= shape[d]
    return idx


def _route(device, what: str) -> torch.device:
    """The device a draw runs on: a card (the kernel), the CPU (the plain
    path) or ``meta`` (shapes); any other raises."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    return dev


def _record(dev: torch.device, nbytes: int) -> None:
    """A draw's formula cost, on a card or ``meta`` while a count is open:
    the bytes it writes (or reads), and no FLOPs — its work is integer and
    transcendental operations outside the count's FLOP formulas, which the
    plain path's ATen ops on the CPU do not reach either, so a step counts
    the same FLOPs on a card, on ``meta`` and on the CPU."""
    if dev.type != "cpu" and _cost.counting():
        _cost.record_kernel(0.0, float(nbytes))


def _draw(key, shape, device, start: int, block, values) -> torch.Tensor:
    """``values(bits)`` (float32, elementwise, from int32 bit patterns) of a
    draw of ``shape`` under ``key``, or of its ``block``: the block of the
    whole draw, bit for bit, by each element's global counter.  Works in
    slices of :data:`CHUNK` elements, so the temporaries stay bounded.
    The plain path (the CPU, and shapes on ``meta``)."""
    shape = tuple(int(n) for n in shape)
    _check_counter(start + math.prod(shape))
    parts = _block_of(shape, block)
    out_shape = tuple(length for _, length in parts)
    n = math.prod(out_shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for a in range(0, n, CHUNK):
        b = min(n, a + CHUNK)
        out[a:b] = values(_bits32_at(key, _flat_counters(shape, parts, start, a, b,
                                                         device)))
    return out.reshape(out_shape)


def _scaled(z: torch.Tensor, op, c: float, dtype) -> torch.Tensor:
    """The plain path's epilogue: ``c * z`` (``op="mul"``) or ``z / c``
    (``op="div"``) with float32 ``c``, each rounded once, then cast to
    ``dtype`` (nearest even)."""
    cf = float(np.float32(c))
    if op == "mul":
        z = cf * z  # a float32 product
    elif op == "div":
        z = z / cf  # IEEE float32 division, as XLA's (not z * (1 / c))
    return z if dtype == torch.float32 else z.to(dtype)


def _draw_routed(key, shape, device, start: int, block, value: str, values,
                 lo: float = 0.0, span: float = 1.0, op=None, c: float = 1.0,
                 dtype=torch.float32) -> torch.Tensor:
    """:func:`_draw` of ``values`` on the CPU and ``meta``, the draw kernel's
    ``value`` on a card (``lo``, ``span``: a uniform's float32 bounds),
    then ``op`` with ``c`` and the cast to ``dtype``."""
    dev = _route(device, "jax.random draw")
    shape = tuple(int(n) for n in shape)
    _check_counter(start + math.prod(shape))
    parts = _block_of(shape, block)
    n = math.prod(length for _, length in parts)
    _record(dev, dtype.itemsize * n)
    if dev.type == "cuda":
        return _jd.jax_draw(as_key(key), shape, parts, value, dev, start=start, op=op,
                            c=c, lo=lo, span=span, dtype=dtype)
    if dev.type == "meta":
        return torch.empty(tuple(length for _, length in parts), dtype=dtype, device=dev)
    return _scaled(_draw(key, shape, dev, start, block, values), op, c, dtype)


def randint_params(key, maxval: int) -> tuple:
    """What :func:`randint` draws from, computed once on the host: the two
    subkeys of the high and low bit streams, the span and the multiplier
    ``2**32 mod span`` (``jax.random.randint``'s double-width remainder,
    whose ``uint32`` square wraps to 0 for a span past ``2**16``)."""
    span = max(int(maxval), 1) & M32
    k_hi, k_lo = split(key, 2)
    mult = ((2**16 % span) ** 2 & M32) % span  # a uint32 product: 0 past 2**16
    return k_hi, k_lo, span, mult


def fastmod_magic(span: int) -> int:
    """The constant with which the CUDA kernels take ``x mod span`` of a
    uint32 ``x`` by two multiplications, no division
    (``csrc/randint.cuh::fastmod_u32``: ``((magic * x) mod 2**64) * span
    >> 64``): ``floor((2**64 - 1) / span) + 1``, mod ``2**64``."""
    return ((2**64 - 1) // int(span) + 1) % 2**64


def randint(key, n: int, maxval: int, device="cpu", start: int = 0) -> torch.Tensor:
    """``jax.random.randint(key, (n,), 0, maxval, int32)`` bit for bit, for
    ``1 <= maxval < 2**31`` (a coordinate delay's span, a vocabulary): two
    bit streams from the split key, each reduced mod span, recombined with
    ``2**32 mod span`` in ``uint32`` arithmetic, as JAX's.  ``start``
    offsets the counters, as :func:`random_bits`' does: elements ``[start,
    start + n)`` of a longer draw, past 2**32 too.  Returns int32; works in
    slices of :data:`CHUNK`."""
    if not 1 <= int(maxval) < 2**31:
        raise ValueError(f"maxval {maxval} outside [1, 2**31)")
    _check_counter(start + n)
    k_hi, k_lo, span, mult = randint_params(key, maxval)
    keys = torch.tensor([k_hi, k_lo], dtype=torch.int64, device=device)
    out = torch.empty(n, dtype=torch.int32, device=device)
    for a in range(0, n, CHUNK):
        b = min(n, a + CHUNK)
        # both streams in one pass: a key a row, at the same counters
        bits = _bits32_at((keys[:, :1], keys[:, 1:]),
                          _counters(start + a, start + b, device)[None]).long() & M32
        hi = (bits[0] % span) * mult & M32
        out[a:b] = (((hi + bits[1] % span) & M32) % span).to(torch.int32)
    return out


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit values -> float32 uniforms in (0, 1): the top 24 bits, offset
    by 2^-25."""
    u = (bits >> 8).to(torch.float32) * (2.0**-24)
    return u + 2.0**-25


def normal_from_counter(seed0, seed1, counter: torch.Tensor) -> torch.Tensor:
    """Standard normals (float32) from int64 element counters < 2^32, by
    Box-Muller over ``threefry2x32(seed, (c, c ^ 0x9E3779B9))``."""
    b0, b1 = threefry2x32(seed0, seed1, counter, counter ^ GOLDEN)
    u1 = uniform_from_bits(b0)
    u2 = uniform_from_bits(b1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(torch.tensor(TWO_PI, dtype=torch.float32) * u2)


def normal(seed, start: int, stop: int, device="cpu") -> torch.Tensor:
    """The noise of flat elements ``[start, stop)`` under ``seed``.  Refused
    past 2**32 elements: this is the fused update's plain version, and the
    reference's Pallas kernel takes a ``uint32`` counter, which wraps
    there (``repro.kernels.langevin_update``) — a difference by design of
    that kernel, not of the draws above."""
    if stop > 2**32:
        raise ValueError(f"{stop} elements exceed the 32-bit counter")
    return normal_from_counter(seed[0], seed[1], _counters(start, stop, device))


def seed_int(key) -> int:
    """A 63-bit ``torch.Generator`` seed from a key (the unfused path's
    noise, which does not reproduce ``jax.random.normal``)."""
    return ((int(key[0]) << 31) ^ int(key[1])) & (2**63 - 1)


# ---------------------------------------------------------------------------
# jax.random.uniform / jax.random.normal (float32), as XLA computes them on
# the CPU.  The potentials draw their problems and minibatches with these, so
# the same key gives the same problem in both packages.
# ---------------------------------------------------------------------------
def _f64(v):
    return v.double() if torch.is_tensor(v) else float(v)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's contracted multiply-add:
    the product of two float32 values is exact in float64."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def _uniform_bounds(minval: float, maxval: float) -> tuple:
    """``(lo, span)``: float32 ``minval`` and ``float32(maxval) - lo``,
    rounded as numpy rounds them."""
    lo = np.float32(minval)
    return lo, np.float32(maxval) - lo


def _uniform_values(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """Uniforms from int32 bit patterns (:func:`_bits32_at`)."""
    u = (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    lo, span = _uniform_bounds(minval, maxval)
    return torch.clamp_min(_fma(u, span, lo), float(lo))


def jax_uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
                device="cpu", start: int = 0, block=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` bit for
    bit: 23 random mantissa bits under exponent 0 (a float in [1, 2)),
    minus 1, then ``max(minval, u * (maxval - minval) + minval)`` with the
    multiply-add fused (XLA contracts it on the CPU).  ``start``: the
    draw's flat elements from ``start`` on (see :func:`random_bits`).
    ``block`` (a slice a dimension of ``shape``): that block of the draw
    alone, each element at its counter in the whole — a placed leaf's
    block, bit for bit the whole draw's."""
    lo, span = _uniform_bounds(minval, maxval)
    return _draw_routed(key, shape, device, start, block, "uniform",
                        lambda bits: _uniform_values(bits, minval, maxval), lo, span)


# XLA's float32 log: Cephes' logf on the mantissa in [sqrt(1/2), sqrt(2))
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# XLA's log1p below sqrt(2) - 1: Cephes' rational, highest power first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Giles' single-precision erfinv in w = -log1p(-x^2), split at w = 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` for x > 0 (Cephes: exponent and mantissa
    apart, a degree-8 polynomial, the same multiply-adds fused)."""
    x = torch.clamp_min(x, _f32(1.17549435e-38))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _f32(0.707106781186547524)
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    p = [_f32(c) for c in _LOG_P]
    m64 = m.double()
    y, y1, y2 = (_fma_chain(torch.full_like(m, p[i]), m64, p[i + 1:i + 3])
                 for i in (0, 3, 6))
    y = _fma_chain(y, x3.double(), [y1, y2, e * _f32(_LOG_Q1)])
    m = m - 0.5 * x2
    return (m + y) + e * _f32(_LOG_Q2)


def _fma_chain(p: torch.Tensor, x64: torch.Tensor, coeffs) -> torch.Tensor:
    """``p = fma(p, x, c)`` for each ``c`` of ``coeffs`` in turn (float32
    values, each step rounded once as :func:`_fma`), with ``x`` converted
    to float64 once: ``x64``.  ``coeffs`` are floats or float64 tensors
    broadcasting against ``x``."""
    for c in coeffs:
        p = p.double().mul_(x64).add_(c).float()
    return p


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, _f32(coeffs[0]))
    return _fma_chain(p, x.double(), [_f32(c) for c in coeffs[1:]])


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: a rational approximation below sqrt(2) - 1
    in magnitude, ``log(1 + x)`` above."""
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + (-0.5 * x2 + (x * x2) * r)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _xla_log(x + 1.0))


def _xla_erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles), for x in (-1, 1); +-1 map to
    +-max float, as in XLA.  (``torch.erfinv`` is another approximation.)"""
    w = -_xla_log1p(-(x * x))
    lt = w < 5.0
    # sqrt in float64 then rounded: correctly rounded, as XLA's is
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    lo = torch.tensor([_f32(c) for c in _ERFINV_LT5], dtype=torch.float64,
                      device=x.device)
    hi = torch.tensor([_f32(c) for c in _ERFINV_GE5], dtype=torch.float64,
                      device=x.device)
    p = torch.where(lt, lo[0], hi[0]).float()
    p = _fma_chain(p, w.double(), (torch.where(lt, lo[i], hi[i])
                                   for i in range(1, len(_ERFINV_LT5))))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def jax_normal(key, shape, device="cpu", start: int = 0, block=None, *,
               scale: float | None = None, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erf_inv(u)`` with u uniform in ``(nextafter(-1, 0), 1)`` and XLA's
    ``erf_inv``, ``log1p`` and ``log``, so the draws are JAX's on the CPU:
    ``tests/test_torch_potentials.py`` holds them within 4 ulps and bit for
    bit on 99% of draws (every draw it tests is equal).  ``start`` and
    ``block`` as :func:`jax_uniform`'s: a placed leaf draws its block of
    the whole leaf's draw, never the whole.  ``scale`` (optional): the
    float32 product ``scale * z``, then the cast to ``dtype`` — the
    reference's ``(scale * normal(key, shape)).astype(dtype)``, one launch
    on a card."""
    return _draw_routed(key, shape, device, start, block, "normal", _normal_values,
                        op=None if scale is None else "mul",
                        c=1.0 if scale is None else scale, dtype=dtype)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_ROOT2 = np.float32(math.sqrt(2.0)).item()


def _normal_values(bits: torch.Tensor) -> torch.Tensor:
    """``sqrt(2) * erf_inv(u)`` from int32 bit patterns."""
    return _ROOT2 * _xla_erf_inv(_uniform_values(bits, _NORMAL_LO, 1.0))


# ---------------------------------------------------------------------------
# jax.random.gumbel / jax.random.categorical (float32): the sampled tokens of
# the serving engines, the reference's for the same key and log-probs
# ---------------------------------------------------------------------------
_TINY = float(np.finfo(np.float32).tiny)


def _gumbel_values(bits: torch.Tensor) -> torch.Tensor:
    """``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)`` and XLA's
    float32 ``log`` both times (``jax.random.gumbel``'s ``mode="low"``)."""
    return -_xla_log(-_xla_log(_uniform_values(bits, _TINY, 1.0)))


def gumbel(key, shape, device="cpu", start: int = 0, block=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` bit for bit; ``start`` and
    ``block`` as :func:`jax_uniform`'s."""
    return _draw_routed(key, shape, device, start, block, "gumbel", _gumbel_values)


def _local_logp(logp: torch.Tensor, what: str) -> torch.device:
    """``logp``'s device, routed (:func:`_route`); refuses a ``DTensor``, as
    :func:`repro_torch.kernels.ops._local_only` does."""
    if is_placed(logp):
        raise TypeError(f"{what} takes a rank's local tensors, got a DTensor: "
                        "pass its to_local() rows (repro_torch.utils.local)")
    return _route(logp.device, what)


def _logp_rows(logp: torch.Tensor) -> tuple:
    """``logp`` as the categorical kernel's contiguous ``(B, V)`` rows (in
    its own dtype where the kernel reads it, else float32) and the batch
    shape the tokens take."""
    x = logp if logp.dtype in _cat.DTYPES else logp.float()
    V = logp.shape[-1]
    return x.reshape(-1, V).contiguous(), logp.shape[:-1]


def categorical(key, logp: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logp, axis=-1)``: the argmax of
    ``logp + gumbel(key, logp.shape)``, added in float32.  JAX's counters
    are flat, so row ``i`` of a ``(B, V)`` draw takes counters ``[i V, (i +
    1) V)``.  On a card one launch of the categorical kernel; on the CPU
    plain torch ops.  int64 tokens."""
    dev = _local_logp(logp, "categorical")
    _record(dev, logp.numel() * logp.element_size())
    if dev.type == "cuda":
        rows, batch = _logp_rows(logp)
        return _cat.categorical(rows, key=as_key(key)).reshape(batch)
    return categorical_plain(key, logp)


def categorical_plain(key, logp: torch.Tensor) -> torch.Tensor:
    """:func:`categorical`'s plain version, plain torch ops on ``logp``'s
    device (the CPU path; on a card, what the kernel is held against)."""
    g = _draw(as_key(key), logp.shape, logp.device, 0, None, _gumbel_values)
    return torch.argmax(logp.float() + g, dim=-1)


def categorical_rows(keys, logp: torch.Tensor) -> torch.Tensor:
    """``vmap(jax.random.categorical)(keys, logp)``: row ``s`` of ``logp``
    ``(S, V)`` drawn under its own key ``keys[s]`` (``(S, 2)``, e.g. from
    :func:`fold_in_rows`), each at counters ``[0, V)``.  On a card one
    launch of the categorical kernel (the keys as 32-bit words on the
    card); on the CPU one pass over the block, not S draws."""
    dev = _local_logp(logp, "categorical_rows")
    _record(dev, logp.numel() * logp.element_size())
    if dev.type == "cuda":
        rows, batch = _logp_rows(logp)
        return _cat.categorical(rows, keys=_key_words(keys, dev)).reshape(batch)
    return categorical_rows_plain(keys, logp)


def categorical_rows_plain(keys, logp: torch.Tensor) -> torch.Tensor:
    """:func:`categorical_rows`' plain version on ``logp``'s device."""
    dev = logp.device
    keys = _int64(keys).reshape(-1, 2).to(dev)
    c = torch.arange(logp.shape[-1], dtype=torch.int32, device=dev)[None]
    x0, x1 = _threefry32(keys[:, :1], keys[:, 1:], torch.zeros_like(c), c)
    return torch.argmax(logp.float() + _gumbel_values(x0.bitwise_xor_(x1)), dim=-1)


def _key_words(keys, device) -> torch.Tensor:
    """Keys ``(R, 2)`` (ints, an array, or a tensor of 32-bit values) as
    contiguous int32 words holding their bits on ``device``: one copy from
    the host, or one conversion where they already lie there."""
    if torch.is_tensor(keys) and keys.device == device:
        return keys.reshape(-1, 2).to(torch.int32).contiguous()  # wraps to the bits
    words = np.asarray(_int64(keys).cpu(), np.int64).reshape(-1, 2) & M32
    return to_device(words.astype(np.uint32).view(np.int32), device)


# ---------------------------------------------------------------------------
# a key a row: the weights of init_params (a layer-stacked or chain-stacked
# leaf, jax.vmap of a draw over keys)
# ---------------------------------------------------------------------------
def _rows_routed(keys, shape, device, value: str, values, op, c, dtype,
                 lo: float = 0.0, span: float = 1.0) -> torch.Tensor:
    dev = _route(device, "jax.random draw")
    keys = _int64(keys).reshape(-1, 2)
    R, shape = keys.shape[0], tuple(int(n) for n in shape)
    n = math.prod(shape)
    _check_counter(n)
    _record(dev, dtype.itemsize * R * n)
    if dev.type == "cuda":
        if R == 1:  # one key: by value, no table to copy
            k = (int(keys[0, 0]) & M32, int(keys[0, 1]) & M32)
            out = _jd.jax_draw(k, (n,), [(0, n)], value, dev, op=op, c=c, lo=lo,
                               span=span, dtype=dtype)
        else:
            out = _jd.jax_draw_rows(_key_words(keys, dev), n, value, op=op, c=c, lo=lo,
                                    span=span, dtype=dtype)
        return out.reshape((R,) + shape)
    if dev.type == "meta":
        return torch.empty((R,) + shape, dtype=dtype, device=dev)
    return rows_plain(keys, shape, dev, values, op, c, dtype)


def rows_plain(keys, shape, device, values, op=None, c: float = 1.0,
               dtype=torch.float32) -> torch.Tensor:
    """The plain version of a draw a key a row (:func:`normal_rows`,
    :func:`uniform_rows`), plain torch ops on ``device``: row r is
    ``values`` of the bits under ``keys[r]``, then ``op`` and the cast.
    The rows go through together, a ``(rows, counters)`` grid of
    :data:`CHUNK` elements a pass, each row under its own key words."""
    keys = _int64(keys).reshape(-1, 2).to(device)
    R, n = keys.shape[0], math.prod(shape)
    out = torch.empty((R, n), dtype=dtype, device=device)
    g = max(1, CHUNK // max(n, 1))  # rows a pass
    for r in range(0, R, g):
        k = keys[r:r + g]
        for a in range(0, n, CHUNK):
            b = min(n, a + CHUNK)
            cnt = _counters(a, b, device)[None]
            x0, x1 = _threefry32(k[:, :1], k[:, 1:], (cnt >> 32).to(torch.int32),
                                 cnt.to(torch.int32))
            out[r:r + g, a:b] = _scaled(values(x0.bitwise_xor_(x1)), op, c, dtype)
    return out.reshape((R,) + tuple(shape))


def normal_rows(keys, shape, device="cpu", *, op=None, c: float = 1.0,
                dtype=torch.float32) -> torch.Tensor:
    """Row r of ``(R, *shape)``: ``jax.random.normal(keys[r], shape)`` in
    float32, then ``c * z`` (``op="mul"``) or ``z / c`` (``op="div"``),
    float32 ``c``, rounded once, then cast to ``dtype`` — the reference's
    ``(std * normal(key, shape)).astype(dtype)`` under ``jax.vmap`` over
    ``keys`` (``(R, 2)`` 32-bit words: ints, an array or a tensor).  On a
    card one launch (one key: by value; more: a key table)."""
    return _rows_routed(keys, shape, device, "normal", _normal_values, op, c, dtype)


def uniform_rows(keys, shape, minval: float, maxval: float,
                 device="cpu") -> torch.Tensor:
    """Row r of ``(R, *shape)``: ``jax.random.uniform(keys[r], shape,
    float32, minval, maxval)``."""
    lo, span = _uniform_bounds(minval, maxval)
    return _rows_routed(keys, shape, device, "uniform",
                        lambda bits: _uniform_values(bits, minval, maxval), None, 1.0,
                        torch.float32, lo, span)


def split_rows(keys, num: int) -> list:
    """``vmap(jax.random.split, (0, None))(keys, num)`` as ``num`` tables:
    table ``i`` ``(R, 2)`` int64 holds ``split(keys[r], num)[i]`` in row r
    (``keys`` ``(R, 2)``: ints, an array or a tensor)."""
    keys = _int64(keys).reshape(-1, 2)
    zero = torch.zeros(keys.shape[0], dtype=torch.int64)
    out = []
    for i in range(num):
        x0, x1 = threefry2x32(keys[:, 0], keys[:, 1], zero, zero + i)
        out.append(torch.stack([x0, x1], dim=1))
    return out
