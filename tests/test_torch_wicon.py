"""The one-pass W-Icon read of the port (draw each coordinate's delay, then
read its snapshot), against the JAX package, on the CPU.

- ``ref.wicon_read_ref`` and ``core.delay.read_inconsistent_leafwise(...,
  fused=True)`` (the route the CUDA ``wicon_read`` kernel takes on a card)
  equal ``jax.random.randint`` followed by ``repro.core.delay.
  read_inconsistent`` bit for bit: float32, bfloat16 and int32, rings of
  depth 1-5, every head and every ``maxval``, ragged sizes, and ``-0.0``,
  ``inf`` and ``nan`` in the ring (both sides copy the selected element).
- The remainder constant the kernels take ``x mod span`` with
  (``rng.fastmod_magic``, two multiplications in ``csrc/randint.cuh``)
  gives ``x % span`` exactly for every span of a delay draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delay as jdelay
from repro_torch.core import delay
from repro_torch.kernels import ops, ref, rng
from repro_torch.utils import tree_leaves
from torch_cases import one_cpu_thread  # noqa: F401

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "i32": (np.int32, jnp.int32, torch.int32)}


def _ring(name, depth, shape, seed):
    """A ring as a (jax array, torch tensor) pair of equal bits, with
    ``-0.0``, ``inf`` and ``nan`` among the floats."""
    r = np.random.default_rng(seed)
    npt, jt, tt = DTYPES[name]
    if npt == np.int32:
        a = r.integers(-1000, 1000, (depth, *shape)).astype(np.int32)
    else:
        a = r.standard_normal((depth, *shape)).astype(np.float32)
        flat = a.reshape(-1)
        flat[: min(4, flat.size)] = np.array([-0.0, np.inf, np.nan, -0.0],
                                             np.float32)[: min(4, flat.size)]
    j = jnp.asarray(a).astype(jt)
    raw = np.array(j).view(np.int16 if jt == jnp.bfloat16 else npt)
    return j, torch.from_numpy(raw).view(tt)


def _bits(a):
    """Raw bits of a jax array or torch tensor, as a numpy byte string."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(a).tobytes()


def _jax_read(jhist, head, depth, delays):
    ring = jdelay.RingBuffer(history={"w": jhist}, head=jnp.int32(head),
                             depth=depth)
    return jdelay.read_inconsistent(ring, {"w": delays})["w"]


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("name", list(DTYPES))
def test_plain_wicon_read_equals_jax_randint_then_read(name, depth):
    n = 1003  # ragged
    jh, th = _ring(name, depth, (n,), seed=depth)
    for head in range(depth):
        for maxval in range(1, depth + 1):
            key = (17 * head + maxval, depth)
            jd = jax.random.randint(jnp.asarray(key, jnp.uint32), (n,), 0,
                                    maxval, dtype=jnp.int32)
            want = _jax_read(jh, head, depth, jd)
            # chains on a leading axis: one chain is C = 1
            got = ref.wicon_read_ref(th[None], [key], [maxval], [head])[0]
            assert got.dtype == th.dtype
            assert _bits(got) == _bits(want), (head, maxval)
            # the op route on CPU tensors: the same read, leaf-shaped
            got = ops.wicon_read(th.reshape(1, depth, 17, 59), [key], [maxval], [head])
            assert got.shape == (1, 17, 59)
            assert _bits(got) == _bits(want), (head, maxval)


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_fused_leafwise_read_equals_jax_draw_then_read(depth):
    """A tree of mixed dtypes and ragged leaves, every head, every staleness
    ``max_delay`` (and one past the ring, which both sides clip)."""
    shapes = {"a": ("f32", (7, 13)), "b": ("bf16", (5, 3)), "c": ("i32", (11,))}
    pairs = {k: _ring(nm, depth, shp, seed=depth + i)
             for i, (k, (nm, shp)) in enumerate(shapes.items())}
    jhist = {k: j for k, (j, _) in pairs.items()}
    thist = {k: t for k, (_, t) in pairs.items()}
    for head in range(depth):
        jring = jdelay.RingBuffer(history=jhist, head=jnp.int32(head), depth=depth)
        ring = delay.RingBuffer(history={k: t[None] for k, t in thist.items()},
                                head=torch.tensor([head]), depth=depth)  # C = 1
        for max_delay in range(depth + 1):
            jkey = jax.random.PRNGKey(100 * depth + 10 * head + max_delay)
            key = rng.PRNGKey(100 * depth + 10 * head + max_delay)
            want = jdelay.read_inconsistent(jring, jdelay.sample_coordinate_delays(
                jkey, jring, jnp.int32(max_delay)))
            got = delay.read_inconsistent_leafwise(ring, [key], [max_delay], fused=True)
            for w, g in zip(jax.tree_util.tree_leaves(want),
                            (g[0] for g in tree_leaves(got))):
                assert g.shape == w.shape
                assert _bits(g) == _bits(w), (head, max_delay)


def _fastmod(x, magic, span):
    """``csrc/randint.cuh::fastmod_u32`` in numpy uint64: ``((magic * x) mod
    2^64) * span >> 64``, the product split at 32 bits (span < 2^16)."""
    frac = magic * x  # wraps mod 2^64
    lo = ((frac & np.uint64(0xFFFFFFFF)) * span) >> np.uint64(32)
    return ((frac >> np.uint64(32)) * span + lo) >> np.uint64(32)


@pytest.mark.parametrize("which", ["edges", "sampled"])
def test_remainder_constant_is_exact_for_every_span(which):
    spans = np.arange(1, 2**16, dtype=np.uint64)
    magic = np.array([rng.fastmod_magic(int(s)) for s in spans], np.uint64)
    if which == "edges":
        xs = [np.zeros_like(spans), spans - 1, spans,
              np.full_like(spans, 2**32 - 1)]
    else:
        r = np.random.default_rng(0)
        xs = [r.integers(0, 2**32, spans.size, dtype=np.uint64) for _ in range(64)]
        # and just below and at multiples of the span near the top
        top = (np.uint64(2**32 - 1) // spans) * spans
        xs += [top, top - np.uint64(1)]
    with np.errstate(over="ignore"):
        for x in xs:
            np.testing.assert_array_equal(_fastmod(x, magic, spans), x % spans)

