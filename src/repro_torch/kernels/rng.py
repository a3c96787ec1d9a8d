"""Counter-based RNG: threefry2x32, Box-Muller and JAX's key discipline,
without JAX (port of ``repro.kernels.rng`` plus the parts of
``jax.random`` the SGLD path draws from).

Two kinds of operand, one code path:

- Python ints, for keys: :func:`split` runs a handful of threefry blocks
  on the host.
- int64 tensors holding 32-bit values, for per-element streams on the CPU
  (PyTorch has no uint32 arithmetic there).  Every add and shift is
  masked back to 32 bits, so the bits equal JAX's ``uint32`` bits.

A key is a ``(k0, k1)`` tuple of 32-bit ints — the two words of a raw JAX
``PRNGKey``.  JAX here runs with ``jax_threefry_partitionable`` (the
default since 0.5), under which ``split(key, n)[i]`` and the random bits of
element ``i`` of a shape are both ``threefry2x32(key, (0, i))``: the
counter is the flat index, split into a high and a low word.

The CUDA kernels (``csrc/threefry.cuh``) compute the same functions in
native ``uint32``; the tests hold this module against ``jax.random``.
"""

from __future__ import annotations

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


def random_bits(key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: ``x0 ^ x1`` of
    ``threefry2x32(key, (0, i))``, as an int64 tensor of 32-bit values."""
    if n >= 2**32:
        raise ValueError(f"{n} elements exceed the 32-bit counter")
    x0, x1 = threefry2x32(key[0], key[1], torch.zeros(n, dtype=torch.int64,
                                                      device=device),
                          _counters(0, n, device))
    return x0 ^ x1


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


def randint(key, n: int, maxval: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, (n,), 0, maxval, int32)`` bit for bit, for
    ``1 <= maxval < 2**16`` (the span of a coordinate delay): two bit
    streams from the split key, each reduced mod span, recombined with
    ``2**32 mod span``.  Returns int32; works in slices of :data:`CHUNK`."""
    if not 1 <= int(maxval) < 2**16:
        raise ValueError(f"maxval {maxval} outside [1, 2**16)")
    k_hi, k_lo, span, mult = randint_params(key, maxval)
    out = torch.empty(n, dtype=torch.int32, device=device)
    for a in range(0, n, CHUNK):
        b = min(n, a + CHUNK)
        c = _counters(a, b, device)
        z = torch.zeros_like(c)
        h0, h1 = threefry2x32(k_hi[0], k_hi[1], z, c)
        l0, l1 = threefry2x32(k_lo[0], k_lo[1], z, c)
        off = (((h0 ^ h1) % span) * mult + (l0 ^ l1) % span) % span
        out[a:b] = off.to(torch.int32)
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
    """The noise of flat elements ``[start, stop)`` under ``seed``."""
    if stop > 2**32:
        raise ValueError(f"{stop} elements exceed the 32-bit counter")
    return normal_from_counter(seed[0], seed[1], _counters(start, stop, device))


def seed_int(key) -> int:
    """A 63-bit ``torch.Generator`` seed from a key (the unfused path's
    noise, which does not reproduce ``jax.random.normal``)."""
    return ((int(key[0]) << 31) ^ int(key[1])) & (2**63 - 1)

