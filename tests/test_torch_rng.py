"""repro_torch.kernels.rng and the plain versions of the SGLD kernels,
against the JAX package.

- Bits: threefry2x32, ``split``, ``key_data``, ``random_bits`` and
  ``randint`` equal JAX's bit for bit (JAX 0.9 with
  ``jax_threefry_partitionable``, its default), past 2^32 elements too,
  where the counter's high word is the flat index's (held against JAX's
  threefry primitive at those counters: no array of 2^32 elements).
- Normals: the Box-Muller floats agree within 1e-6 — the bits are equal,
  but ``log``/``cos`` are ATen's, not XLA's, and differ in the last ulp.
- The plain Langevin update agrees with the Pallas kernel (interpret mode)
  and with the JAX oracle within 1e-6 in float32 and within one bf16 ulp
  in bfloat16: the update itself is the reference's two fused
  multiply-adds, only the noise's ulps differ.
- The plain gather equals ``delay_gather_flat`` bit for bit on finite
  non-zero data, and ``delay_gather_ref`` bit for bit on any data
  (``-0.0``, ``inf``, ``nan``): the Pallas kernel selects by
  multiply-and-sum, which turns a selected ``-0.0`` into ``+0.0``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import delay as jdelay
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rng as jrng
from repro.models.transformer import init_params as jax_init
from repro_torch.core import delay
from repro_torch.kernels import delay_gather as dg
from repro_torch.kernels import langevin_update as lu
from repro_torch.kernels import ops, ref, rng
from repro_torch.samplers.transform import one_chain
from repro_torch.utils import tree_leaves
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401


def _u32(a):
    return np.asarray(a).astype(np.uint32)


def _bf16(a):
    """numpy float32 -> (jax bf16 array, torch bf16 tensor) of equal bits."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


# ---------------------------------------------------------------------------
# bits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
], ids=["zeros", "pi"])
def test_threefry_known_answers(key, ctr, want):
    """Random123's known answers for threefry2x32-20, on ints and tensors."""
    assert rng.threefry2x32(*key, *ctr) == want
    t0, t1 = rng.threefry2x32(*key, torch.tensor([ctr[0]]), torch.tensor([ctr[1]]))
    assert (int(t0), int(t1)) == want


def test_threefry_bits_equal_jax_on_65536_counters():
    c = np.arange(65536, dtype=np.uint32)
    j0, j1 = jrng.threefry2x32(jnp.uint32(5), jnp.uint32(9), jnp.asarray(c),
                               jnp.asarray(c ^ np.uint32(rng.GOLDEN)))
    t = torch.arange(65536)
    p0, p1 = rng.threefry2x32(5, 9, t, t ^ rng.GOLDEN)
    np.testing.assert_array_equal(_u32(j0), p0.numpy().astype(np.uint32))
    np.testing.assert_array_equal(_u32(j1), p1.numpy().astype(np.uint32))


@pytest.mark.parametrize("n", [2, 3, 14])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_split_and_key_bits_equal_jax(seed, n):
    jkey = jax.random.PRNGKey(seed)
    key = rng.PRNGKey(seed)
    assert rng.key_bits(key) == tuple(_u32(jax.random.key_data(jkey)).tolist())
    np.testing.assert_array_equal(_u32(jax.random.split(jkey, n)),
                                  np.array(rng.split(key, n), np.uint32))


def test_random_bits_equal_jax():
    jkey = jax.random.PRNGKey(11)
    want = _u32(jax.random.bits(jkey, (5000,), jnp.uint32))
    got = rng.random_bits(rng.PRNGKey(11), 5000).numpy().astype(np.uint32)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("maxval", [1, 2, 3, 5, 9])
def test_randint_equals_jax(maxval):
    """``jax.random.randint`` bit for bit, with the traced maxval of
    ``sample_coordinate_delays``."""
    jkey = jax.random.PRNGKey(21)
    want = jax.jit(lambda k, m: jax.random.randint(k, (37, 41), 0, m,
                                                   dtype=jnp.int32))(
        jkey, jnp.int32(maxval))
    got = rng.randint(rng.PRNGKey(21), 37 * 41, maxval)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want).reshape(-1), got.numpy())


# ---------------------------------------------------------------------------
# counters past 2^32: JAX draws element i at (i >> 32, i & 0xFFFFFFFF)
# ---------------------------------------------------------------------------
#: counters on both sides of 2^32 and near 2^40
PAST_2_32 = [2**32 - 3, 2**32 + 5, 2**40 - 2, 2**40 + 9]


def _jax_bits_at(key, counters):
    """``x0 ^ x1`` of JAX's threefry2x32 primitive at the 64-bit counters,
    split into their high and low words: the bits ``jax.random.bits``
    gives element i of a shape (held against it below 2^32 by
    :func:`test_the_counter_construction_is_jaxs`)."""
    from jax.extend.random import threefry2x32_p

    c = np.asarray(counters, np.uint64)
    x0, x1 = threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                 jnp.asarray((c >> np.uint64(32)).astype(np.uint32)),
                                 jnp.asarray((c & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    return np.asarray(x0 ^ x1)


@jax.jit
def _floats(bits, lo, hi):
    """Bits to ``jax.random.uniform``'s float32 in ``[lo, hi)``, as it turns
    them into floats (jitted: XLA contracts the multiply-add as there)."""
    u = jax.lax.bitcast_convert_type((bits >> 9) | jnp.uint32(0x3F800000),
                                     jnp.float32) - 1.0
    return jnp.maximum(lo, u * (hi - lo) + lo)


def _jax_uniform_at(key, counters, lo, hi):
    """``jax.random.uniform``'s float32 at those counters."""
    return _floats(jnp.asarray(_jax_bits_at(key, counters)), jnp.float32(lo),
                   jnp.float32(hi))


def _jax_normal_at(key, counters):
    """``jax.random.normal``'s float32 at those counters: ``sqrt(2)
    erf_inv(u)``, u uniform in ``(nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = _jax_uniform_at(key, counters, lo, 1.0)
    return np.asarray(jax.jit(lambda u: jnp.float32(np.sqrt(2.0)) * jax.lax.erf_inv(u))(u))


def test_the_counter_construction_is_jaxs():
    """Below 2^32 the construction the tests past it use is
    ``jax.random``'s own: bits, uniforms and normals of a shape."""
    jkey = jax.random.PRNGKey(5)
    key = tuple(int(k) for k in jax.random.key_data(jkey))
    c = np.arange(3000)
    np.testing.assert_array_equal(_jax_bits_at(key, c),
                                  _u32(jax.random.bits(jkey, (3000,), jnp.uint32)))
    np.testing.assert_array_equal(np.asarray(_jax_uniform_at(key, c, -1.0, 2.0)),
                                  np.asarray(jax.random.uniform(jkey, (3000,),
                                                                jnp.float32, -1.0, 2.0)))
    np.testing.assert_array_equal(_jax_normal_at(key, c),
                                  np.asarray(jax.random.normal(jkey, (3000,), jnp.float32)))


@pytest.mark.parametrize("start", PAST_2_32)
def test_host_bits_past_2_32_equal_jax(start):
    """``_bits_at``, ``_bits32_at`` and ``random_bits(start=)`` at counters
    past 2^32: the high word goes in, bit for bit JAX's."""
    key = rng.PRNGKey(77)
    c = np.arange(start, start + 64)
    want = _jax_bits_at(key, c)
    ct = torch.from_numpy(c.astype(np.int64))
    np.testing.assert_array_equal(rng._bits_at(key, ct).numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(rng._bits32_at(key, ct).numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        rng.random_bits(key, 64, start=start).numpy().astype(np.uint32), want)


@pytest.mark.parametrize("start", PAST_2_32)
@pytest.mark.parametrize("maxval", [1, 3, 4, 7])
def test_randint_past_2_32_equals_jax(start, maxval):
    """``randint(start=)`` past 2^32: ``jax.random.randint``'s two streams
    from the split key at those counters, reduced as it reduces them
    (``test_randint_equals_jax`` holds the reduction against
    ``jax.random.randint`` itself); ``start=0`` is the unshifted draw."""
    jkey = jax.random.PRNGKey(31)
    key = tuple(int(k) for k in jax.random.key_data(jkey))
    k_hi, k_lo = (tuple(int(w) for w in k)
                  for k in np.asarray(jax.random.key_data(jax.random.split(jkey))))
    c = np.arange(start, start + 96)
    span = np.uint64(maxval)
    mult = np.uint64((2**32 % maxval) if maxval > 1 else 0)
    hi = _jax_bits_at(k_hi, c).astype(np.uint64) % span
    lo = _jax_bits_at(k_lo, c).astype(np.uint64) % span
    want = ((hi * mult + lo) % span).astype(np.int32)
    got = rng.randint(key, 96, maxval, start=start)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rng.randint(key, 10, maxval, start=5).numpy(),
                                  rng.randint(key, 15, maxval).numpy()[5:])


PHI_EXPERTS = (32, 16, 6400, 4096)  # phi3.5-moe's expert stack, 1.34e10 elements


@pytest.mark.parametrize("block", [
    (slice(10, 11), slice(3, 4), slice(5375, 5377), slice(4090, 4096)),
    (slice(31, 32), slice(15, 16), slice(6399, 6400), slice(4000, 4096)),
], ids=["across-2^32", "last"])
def test_a_block_of_phi_moes_expert_stack_draws_jaxs_numbers(block):
    """A block of a ``(32, 16, 6400, 4096)`` draw — phi3.5-moe's expert
    stack, past 2^32 elements — draws without a ``ValueError``, each
    element ``jax.random.normal`` / ``uniform``'s at its flat counter: the
    first block holds both sides of 2^32 (element ``(10, 3, 5376, 0)`` is
    counter 2^32), the second the stack's last elements."""
    key = rng.PRNGKey(9)
    grids = np.meshgrid(*[np.arange(s.start, s.stop) for s in block], indexing="ij")
    c = np.ravel_multi_index([g.ravel() for g in grids], PHI_EXPERTS).astype(np.uint64)
    shape = tuple(s.stop - s.start for s in block)
    if block[0].start == 10:
        assert c.min() < 2**32 <= c.max()
    np.testing.assert_array_equal(rng.jax_normal(key, PHI_EXPERTS, block=block).numpy(),
                                  _jax_normal_at(key, c).reshape(shape))
    np.testing.assert_array_equal(
        rng.jax_uniform(key, PHI_EXPERTS, -1.0, 2.0, block=block).numpy(),
        np.asarray(_jax_uniform_at(key, c, -1.0, 2.0)).reshape(shape))


@pytest.mark.parametrize("start", [2**32 - 100, 2**40 - 50])
def test_jax_normal_with_a_start_past_2_32_is_jaxs(start):
    """``jax_normal`` / ``jax_uniform`` with ``start`` so that the draw
    crosses 2^32 or runs near 2^40: JAX's numbers at those counters."""
    key = rng.PRNGKey(13)
    c = np.arange(start, start + 200)
    np.testing.assert_array_equal(rng.jax_normal(key, (200,), start=start).numpy(),
                                  _jax_normal_at(key, c))
    np.testing.assert_array_equal(rng.jax_uniform(key, (200,), start=start).numpy(),
                                  np.asarray(_jax_uniform_at(key, c, 0.0, 1.0)))


def test_the_fused_updates_noise_still_refuses_past_2_32():
    """``normal`` — the fused update's plain noise — keeps its 2^32
    refusal: the reference's Pallas counter is uint32 and wraps there, a
    difference by design of that kernel (its CUDA wrapper refuses too:
    ``tests/test_torch_kernels_cuda.py``).  The other draws refuse only
    past the 64-bit counter."""
    with pytest.raises(ValueError, match="32-bit counter"):
        rng.normal((5, 9), 2**32 - 4, 2**32 + 4)
    assert rng.normal((5, 9), 2**32 - 4, 2**32).shape == (4,)
    for draw in (lambda: rng.random_bits((0, 1), 4, start=2**63 - 2),
                 lambda: rng.randint((0, 1), 4, 3, start=2**63 - 2),
                 lambda: rng.jax_normal((0, 1), (2**32, 2**32),
                                        block=(slice(0, 1), slice(0, 1)))):
        with pytest.raises(ValueError, match="64-bit counter"):
            draw()


def test_normals_within_1e6_of_jax():
    c = np.arange(65536, dtype=np.uint32)
    want = np.asarray(jrng.normal_from_counter(jnp.uint32(5), jnp.uint32(9),
                                               jnp.asarray(c)))
    got = rng.normal((5, 9), 0, 65536).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the plain Langevin update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1000, 262145, 300001])
def test_plain_langevin_update_matches_pallas_and_oracle(n):
    r = np.random.default_rng(n)
    x = r.standard_normal(n).astype(np.float32)
    g = r.standard_normal(n).astype(np.float32)
    seed, gamma = (12345, 678), np.float32(1e-3)
    scale = np.sqrt(np.float32(2.0 * 0.5) * gamma)
    jseed = jnp.asarray(seed, jnp.uint32)
    pallas = np.asarray(jops.langevin_update_flat(jnp.asarray(x), jnp.asarray(g),
                                                  jseed, gamma, scale))
    # the plain version takes chains on a leading axis: one chain is C = 1
    got = ref.langevin_update_ref(torch.from_numpy(x.copy())[None],
                                  torch.from_numpy(g)[None], [seed], [gamma],
                                  [scale])[0]
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-6)
    R = -(-n // 1024)  # the oracle takes (R, L) tiles: pad the tail with 0
    xp, gp = (np.pad(a, (0, R * 1024 - n)).reshape(R, 1024) for a in (x, g))
    oracle = np.asarray(jref.langevin_update_ref(jnp.asarray(xp), jnp.asarray(gp),
                                                 jseed, gamma, scale))
    np.testing.assert_allclose(got.numpy(), oracle.reshape(-1)[:n], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n", [1000, 300001])
def test_plain_langevin_update_bf16_within_one_ulp(n):
    r = np.random.default_rng(n + 1)
    (jx, tx), (jg, tg) = (_bf16(r.standard_normal(n).astype(np.float32))
                          for _ in range(2))
    seed, gamma, scale = (3, 4), np.float32(0.1), np.float32(0.5)
    want = np.asarray(jops.langevin_update_flat(
        jx, jg, jnp.asarray(seed, jnp.uint32), gamma, scale).astype(jnp.float32))
    tx1 = tx[None]
    got = ref.langevin_update_ref(tx1, tg[None], [seed], [gamma], [scale])
    assert got is tx1 and got.dtype == torch.bfloat16  # in place
    got = tx
    ulp = np.abs(want) * 2.0**-7 + 1e-30
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


def test_fused_update_on_reduced_qwen3_tree_matches_jax():
    """The whole bf16 parameter tree: each leaf's seed fold and index follow
    JAX's sorted-key leaf order (a leaf in another position would get
    another leaf's noise, 0.5 * N(0,1) apart)."""
    cfg = jax_reduced("qwen3-4b")
    jp = jax_init(jax.random.PRNGKey(1), cfg)
    jg = jax.tree_util.tree_map(lambda p: (p * 0.5).astype(p.dtype), jp)
    seed, gamma, scale = (0xDEADBEEF, 42), np.float32(0.1), np.float32(0.5)
    want = jops.fused_langevin_update(jp, jg, jnp.asarray(seed, jnp.uint32),
                                      gamma, scale)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tp = from_jax_params(host(jp), device="cpu")
    tg = from_jax_params(host(jg), device="cpu")
    stacked = one_chain(tp)  # the op takes chains stacked: C = 1
    got = ops.fused_langevin_update(stacked, one_chain(tg), [seed], [gamma], [scale])
    assert got is stacked
    leaves = jax.tree_util.tree_leaves(want)
    assert len(leaves) == 14
    for w, t in zip(leaves, tree_leaves(tp)):  # in place on tp
        w = np.asarray(w.astype(jnp.float32))
        ulp = np.abs(w) * 2.0**-7 + 1e-30
        assert (np.abs(t[0].float().numpy() - w) <= ulp).all()


# ---------------------------------------------------------------------------
# the plain gather and the delay draw
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int32],
                         ids=["f32", "bf16", "i32"])
def test_plain_gather_equals_pallas_bitwise(dtype):
    r = np.random.default_rng(0)
    depth, n, head = 3, 5003, 1
    if dtype == np.int32:
        h = r.integers(1, 1000, (depth, n)).astype(np.int32)
    else:
        h = (r.uniform(0.5, 2.0, (depth, n)) * r.choice([-1, 1], (depth, n))
             ).astype(dtype)
    slots = r.integers(0, depth, n).astype(np.int32)
    delays = (head - slots) % depth
    want = np.asarray(jops.delay_gather_flat(jnp.asarray(h), jnp.asarray(slots)))
    th = (torch.from_numpy(h.astype(np.float32)).bfloat16()
          if dtype == ml_dtypes.bfloat16 else torch.from_numpy(h))
    got = ref.delay_gather_ref(th[None], torch.from_numpy(delays.astype(np.int32))[None],
                               [head])[0]
    got = got.float().numpy() if dtype == ml_dtypes.bfloat16 else got.numpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_plain_gather_copies_signed_zero_inf_nan_like_the_oracle():
    h = np.array([[-0.0, np.inf, 1.0, np.nan, 2.0],
                  [3.0, -0.0, -np.inf, 4.0, np.nan]], np.float32)
    slots = np.array([0, 1, 1, 0, 1], np.int32)
    want = np.asarray(jref.delay_gather_ref(jnp.asarray(h), jnp.asarray(slots)))
    got = ref.delay_gather_ref(torch.from_numpy(h)[None],
                               torch.from_numpy((0 - slots) % 2)[None], [0])[0].numpy()
    assert got.tobytes() == want.tobytes()
    assert np.signbit(got[:2]).all()  # the selected -0.0 stays -0.0


def test_coordinate_delays_and_read_equal_jax_on_reduced_tree():
    """``sample_coordinate_delays`` draws JAX's delays bit for bit over the
    14-leaf ring, and the reads through the gather — over the tree, and
    leaf by leaf with the draw, kernel path or not — equal JAX's W-Icon
    read."""
    cfg = jax_reduced("qwen3-4b")
    jp = jax_init(jax.random.PRNGKey(2), cfg)
    jring = jdelay.init_ring(jp, 2)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    ring = one_chain(delay.init_ring(tp, 2))  # the ring of one chain: C = 1
    for k in range(2):  # two pushes of distinct iterates
        jp = jax.tree_util.tree_map(lambda p: (p + 1).astype(p.dtype), jp)
        jring = jdelay.push(jring, jp)
        ring = delay.push(ring, one_chain(from_jax_params(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")))
    jkey = jax.random.PRNGKey(9)
    want = jdelay.sample_coordinate_delays(jkey, jring, jnp.int32(2))
    got = delay.sample_coordinate_delays([rng.PRNGKey(9)], ring, [2])
    for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(w), g[0, 0].numpy())
    jread = jdelay.read_inconsistent(jring, want)
    tree_read = delay.read_inconsistent(ring, got)
    for w, g in zip(jax.tree_util.tree_leaves(jread), tree_leaves(tree_read)):
        np.testing.assert_array_equal(np.asarray(w.astype(jnp.float32)),
                                      g[0, 0].float().numpy())
    for fused in (False, True):
        read = delay.read_inconsistent_leafwise(ring, [rng.PRNGKey(9)], [2],
                                                fused=fused)
        for w, g in zip(jax.tree_util.tree_leaves(jread), tree_leaves(read)):
            np.testing.assert_array_equal(np.asarray(w.astype(jnp.float32)),
                                          g[0, 0].float().numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no silent plain path."""
    x = torch.zeros(1, 8)
    rows = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        lu.langevin_update(x, x, torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA kernel"):
        dg.delay_gather(torch.zeros(1, 2, 8), torch.zeros(1, 8, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="CUDA kernel"):
        dg.coordinate_delays(rows, 8, [2])
    with pytest.raises(ValueError, match="CUDA kernel"):
        dg.wicon_read(torch.zeros(1, 2, 8), rows, [1], 0)
    assert lu.langevin_update.launches == dg.delay_gather.launches == 0
    assert dg.wicon_read.launches == 0
