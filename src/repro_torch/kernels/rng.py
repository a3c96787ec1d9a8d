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
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
GOLDEN = 0x9E3779B9  # the second counter word of a Box-Muller pair
TWO_PI = 2.0 * 3.14159265358979  # rounded to float32 where it is used

#: elements per slice of the tensor paths: bounds the int64 temporaries
CHUNK = 1 << 22


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key0, key1, x0, x1):
    """20-round threefry2x32 (JAX's schedule) of the counter pair
    ``(x0, x1)`` under the key ``(key0, key1)``.  Operands are ints or
    int64 tensors of 32-bit values; returns the output pair likewise."""
    k0, k1 = int(key0) & M32, int(key1) & M32
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
    """``jax.random.split(key, num)`` as a list of ``(k0, k1)`` keys."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


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
    logical one — half the bytes of the int64 form, for the long draws."""
    k0, k1 = int(key0) & M32, int(key1) & M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + _signed(ks[0])
    x1 = x1 + _signed(ks[1])
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 += x1
            x1 = _rotl32(x1, r).bitwise_xor_(x0)
        x0 += _signed(ks[(block + 1) % 3])
        x1 += _signed(ks[(block + 2) % 3] + block + 1)
    return x0, x1


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


def _draw(key, shape, device, start: int, block, values) -> torch.Tensor:
    """``values(bits)`` (float32, elementwise, from int32 bit patterns) of a
    draw of ``shape`` under ``key``, or of its ``block``: the block of the
    whole draw, bit for bit, by each element's global counter.  Works in
    slices of :data:`CHUNK` elements, so the temporaries stay bounded."""
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


def randint_params(key, maxval: int) -> tuple:
    """What :func:`randint` draws from, computed once on the host: the two
    subkeys of the high and low bit streams, the span and the multiplier
    ``2**32 mod span`` (``jax.random.randint``'s double-width remainder)."""
    span = max(int(maxval), 1) & M32
    k_hi, k_lo = split(key, 2)
    mult = (2**16 % span) ** 2 % span
    return k_hi, k_lo, span, mult


def fastmod_magic(span: int) -> int:
    """The constant with which the CUDA kernels take ``x mod span`` of a
    uint32 ``x`` by two multiplications, no division
    (``csrc/randint.cuh::fastmod_u32``: ``((magic * x) mod 2**64) * span
    >> 64``): ``floor((2**64 - 1) / span) + 1``, mod ``2**64``."""
    return ((2**64 - 1) // int(span) + 1) % 2**64


def randint(key, n: int, maxval: int, device="cpu", start: int = 0) -> torch.Tensor:
    """``jax.random.randint(key, (n,), 0, maxval, int32)`` bit for bit, for
    ``1 <= maxval < 2**16`` (the span of a coordinate delay): two bit
    streams from the split key, each reduced mod span, recombined with
    ``2**32 mod span``.  ``start`` offsets the counters, as
    :func:`random_bits`' does: elements ``[start, start + n)`` of a longer
    draw, past 2**32 too.  Returns int32; works in slices of
    :data:`CHUNK`."""
    if not 1 <= int(maxval) < 2**16:
        raise ValueError(f"maxval {maxval} outside [1, 2**16)")
    _check_counter(start + n)
    k_hi, k_lo, span, mult = randint_params(key, maxval)
    out = torch.empty(n, dtype=torch.int32, device=device)
    for a in range(0, n, CHUNK):
        b = min(n, a + CHUNK)
        c = _counters(start + a, start + b, device)
        hi = (_bits_at(k_hi, c) % span) * mult
        out[a:b] = ((hi + _bits_at(k_lo, c) % span) % span).to(torch.int32)
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


def _uniform_values(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """Uniforms from int32 bit patterns (:func:`_bits32_at`)."""
    u = (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
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
    return _draw(key, shape, device, start, block,
                 lambda bits: _uniform_values(bits, minval, maxval))


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


def jax_normal(key, shape, device="cpu", start: int = 0, block=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erf_inv(u)`` with u uniform in ``(nextafter(-1, 0), 1)`` and XLA's
    ``erf_inv``, ``log1p`` and ``log``, so the draws are JAX's on the CPU:
    ``tests/test_torch_potentials.py`` holds them within 4 ulps and bit for
    bit on 99% of draws (every draw it tests is equal).  ``start`` and
    ``block`` as :func:`jax_uniform`'s: a placed leaf draws its block of
    the whole leaf's draw, never the whole."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    root2 = np.float32(math.sqrt(2.0)).item()
    return _draw(key, shape, device, start, block,
                 lambda bits: root2 * _xla_erf_inv(_uniform_values(bits, lo, 1.0)))
