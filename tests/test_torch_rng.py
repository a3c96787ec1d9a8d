"""repro_torch.kernels.rng and the plain versions of the SGLD kernels,
against the JAX package.

- Bits: threefry2x32, ``split``, ``key_data``, ``random_bits`` and
  ``randint`` equal JAX's bit for bit (JAX 0.9 with
  ``jax_threefry_partitionable``, its default).
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
