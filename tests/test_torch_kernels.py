"""repro_torch.kernels: the plain decode steps against the JAX package, and
the CUDA kernels against the plain steps.

On the CPU the port's ``decode_step_ref`` / ``paged_decode_step_ref`` are
held against the JAX Pallas kernels run in interpret mode
(``repro.kernels.ops.fused_*``) and against the JAX oracles
(``repro.kernels.ref``).  Outputs agree to atol 1e-5 in float32 — the op
order is the same and only the summation order of the two einsums
differs; caches and pools are compared exactly.  The CUDA kernels
themselves are held against the plain versions in
``test_torch_kernels_cuda.py``, on a card.

The SGLD plain versions and ops take chains on a leading axis: C chains
are held bit for bit against each chain alone (C = 1), at C 1, 3 and 32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro_torch.kernels import decode_step as ds
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import decode_attention, paged_decode_attention
from torch_cases import (
    G,
    HD,
    KV,
    RING_CASES,
    RING_IDS,
    assert_pool_equal,
    garbage_writers,
    paged_case,
    ring_case,
)

ATOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# plain versions vs the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", RING_CASES, ids=RING_IDS)
def test_decode_step_ref_matches_jax(case):
    c = ring_case(**case)
    want_o, want_k, want_v = jops.fused_decode_step(
        c["q"], c["k_new"], c["v_new"], c["k_cache"], c["v_cache"],
        c["valid"], c["slot"])
    oracle = jref.decode_step_ref(
        c["q"].reshape(-1, KV, G, HD), c["k_new"], c["v_new"], c["k_cache"],
        c["v_cache"], c["valid"], c["slot"])
    t = {k: _t(v) for k, v in c.items() if k != "slot"}
    o, kc, vc = ops.fused_decode_step(t["q"], t["k_new"], t["v_new"],
                                      t["k_cache"], t["v_cache"], t["valid"],
                                      c["slot"])
    assert kc is t["k_cache"] and vc is t["v_cache"]  # updated in place
    np.testing.assert_allclose(_np(o), np.asarray(want_o), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(o), np.asarray(oracle[0]).reshape(o.shape),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(_np(kc), np.asarray(want_k))
    np.testing.assert_array_equal(_np(vc), np.asarray(want_v))


def test_decode_step_ref_chain_stacked_matches_vmapped_jax():
    """A bank's chains flatten into the port's row axis; the JAX package
    reaches the same kernel through vmap over chains."""
    C, B = 3, 2
    c = ring_case(3, C * B, 16, 7, 10)
    shaped = {k: (v.reshape(C, B, *v.shape[1:]) if k not in ("valid", "slot")
                  else v) for k, v in c.items()}
    want_o, want_k, _ = jax.vmap(
        lambda q, kn, vn, kc, vc: jops.fused_decode_step(
            q, kn, vn, kc, vc, c["valid"], c["slot"]))(
        shaped["q"], shaped["k_new"], shaped["v_new"], shaped["k_cache"],
        shaped["v_cache"])
    t = {k: _t(v) for k, v in c.items() if k != "slot"}
    o, kc, _ = ops.fused_decode_step(t["q"], t["k_new"], t["v_new"],
                                     t["k_cache"], t["v_cache"], t["valid"],
                                     c["slot"])
    np.testing.assert_allclose(_np(o), np.asarray(want_o).reshape(o.shape),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(_np(kc), np.asarray(want_k).reshape(kc.shape))


@pytest.mark.parametrize("C", [1, 2], ids=["one-chain", "two-chains"])
def test_paged_decode_step_ref_matches_jax(C):
    """Permuted page tables, a slot at the last position of its pages, and
    two inactive slots sharing the garbage page; the JAX side vmaps its
    one-pool kernel over the chains, as its engine does."""
    c = paged_case(4 + C, C)
    ps = c["k_pages"].shape[2]
    tables, pos = jnp.asarray(c["tables"]), jnp.asarray(c["pos"])
    run = lambda fn: jax.vmap(  # noqa: E731
        lambda q, kn, vn, kp, vp: fn(q, kn, vn, kp, vp, tables, pos))(
        c["q"], c["k_new"], c["v_new"], c["k_pages"], c["v_pages"])
    want_o, want_k, want_v = run(jops.fused_paged_decode_step)
    oracle_o = jax.vmap(lambda q, kn, vn, kp, vp: jref.paged_decode_step_ref(
        q.reshape(q.shape[0], KV, G, HD), kn, vn, kp, vp, tables, pos)[0])(
        c["q"], c["k_new"], c["v_new"], c["k_pages"], c["v_pages"])
    t = {k: _t(v) for k, v in c.items()}
    o, kp, vp = ops.fused_paged_decode_step(
        t["q"], t["k_new"], t["v_new"], t["k_pages"], t["v_pages"],
        t["tables"], t["pos"])
    assert kp is t["k_pages"] and vp is t["v_pages"]
    np.testing.assert_allclose(_np(o), np.asarray(want_o), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(o), np.asarray(oracle_o).reshape(o.shape),
                               rtol=0, atol=ATOL)
    rows = c["tables"][np.arange(5), c["pos"] // ps] * ps + c["pos"] % ps
    shared = {r: [s for s in range(5) if rows[s] == r]
              for r in garbage_writers(c["tables"], c["pos"], ps)}
    assert shared == {0: [3, 4]}
    assert_pool_equal(_np(kp), np.asarray(want_k), shared, c["k_new"], ps)
    assert_pool_equal(_np(vp), np.asarray(want_v), shared, c["v_new"], ps)


def test_plain_decode_attention_agrees_with_the_step():
    """The unfused ``decode_attention`` over the written cache is the same
    function as the fused step (the JAX package's fused-vs-unfused
    contract)."""
    c = ring_case(7, 3, 16, 4, 8)
    t = {k: _t(v) for k, v in c.items() if k != "slot"}
    o, kc, vc = ref.decode_step_ref(t["q"].reshape(3, KV, G, HD), t["k_new"],
                                    t["v_new"], t["k_cache"], t["v_cache"],
                                    t["valid"], c["slot"])
    pos = torch.where(t["valid"] == 1, torch.arange(16, dtype=torch.int32), -1)
    plain = decode_attention(t["q"][:, None], kc, vc, pos, 15)
    np.testing.assert_allclose(_np(plain[:, 0]), _np(o).reshape(3, KV * G, HD),
                               rtol=0, atol=ATOL)


def test_plain_paged_attention_agrees_with_the_step():
    c = paged_case(9, 1)
    t = {k: _t(v) for k, v in c.items()}
    o, kp, vp = ref.paged_decode_step_ref(
        t["q"].reshape(1, 5, KV, G, HD), t["k_new"], t["v_new"], t["k_pages"],
        t["v_pages"], t["tables"], t["pos"])
    active = slice(0, 3)  # the garbage row holds only one inactive slot's k/v
    plain = paged_decode_attention(
        t["q"][0, active, None], kp[0].reshape(-1, KV, HD),
        vp[0].reshape(-1, KV, HD), t["tables"][active], t["pos"][active], 4)
    np.testing.assert_allclose(_np(plain[:, 0]),
                               _np(o[0, active]).reshape(3, KV * G, HD),
                               rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# group 3: 12 query heads over 4 KV heads (the 110M example model)
# ---------------------------------------------------------------------------
KV3, G3 = 4, 3


def test_plain_decode_at_group_3_matches_jax_attention():
    """The plain ring step at G = 3 against the JAX package's unfused
    ``decode_attention`` over a cache written independently here, and
    against its Pallas kernel in interpret mode."""
    c = ring_case(12, 3, 16, 6, 9, kv=KV3, g=G3)
    t = {k: _t(v) for k, v in c.items() if k != "slot"}
    o, kc, _ = ops.fused_decode_step(t["q"], t["k_new"], t["v_new"], t["k_cache"],
                                     t["v_cache"], t["valid"], c["slot"])
    kw, vw = c["k_cache"].copy(), c["v_cache"].copy()
    kw[:, c["slot"]], vw[:, c["slot"]] = c["k_new"], c["v_new"]
    pos = np.where(c["valid"] == 1, np.arange(16), -1).astype(np.int32)
    want = jattention.decode_attention(c["q"][:, None], kw, vw, pos, 15)
    assert o.shape == (3, KV3 * G3, HD)
    np.testing.assert_allclose(_np(o), np.asarray(want)[:, 0], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(_np(kc), kw)
    pallas = jops.fused_decode_step(c["q"], c["k_new"], c["v_new"], c["k_cache"],
                                    c["v_cache"], c["valid"], c["slot"])[0]
    np.testing.assert_allclose(_np(o), np.asarray(pallas), rtol=0, atol=ATOL)


def test_plain_paged_decode_at_group_3_matches_jax_attention():
    """The plain paged step at G = 3, two chains, against the JAX package's
    unfused ``paged_decode_attention`` on each chain's pool, written here
    (the active slots; the inactive ones share the garbage page)."""
    C = 2
    c = paged_case(13, C, kv=KV3, g=G3)
    ps = c["k_pages"].shape[2]
    t = {k: _t(v) for k, v in c.items()}
    o, _, _ = ops.fused_paged_decode_step(t["q"], t["k_new"], t["v_new"], t["k_pages"],
                                          t["v_pages"], t["tables"], t["pos"])
    active = [0, 1, 2]
    kw, vw = c["k_pages"].copy(), c["v_pages"].copy()
    for s in active:
        page, off = c["tables"][s, c["pos"][s] // ps], c["pos"][s] % ps
        kw[:, page, off], vw[:, page, off] = c["k_new"][:, s], c["v_new"][:, s]
    for ch in range(C):
        want = jattention.paged_decode_attention(
            c["q"][ch, active, None], kw[ch].reshape(-1, KV3, HD),
            vw[ch].reshape(-1, KV3, HD), c["tables"][active], c["pos"][active], ps)
        np.testing.assert_allclose(_np(o[ch, active]), np.asarray(want)[:, 0],
                                   rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# wrappers: CPU routing and argument checks (no card needed)
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    c = ring_case(0, 2, 8, 1, 4)
    t = {k: _t(v) for k, v in c.items() if k != "slot"}
    before = ds.decode_step.launches
    ops.fused_decode_step(t["q"], t["k_new"], t["v_new"], t["k_cache"],
                          t["v_cache"], t["valid"], c["slot"])
    assert ds.decode_step.launches == before


@pytest.mark.parametrize("fault", ["device", "shape", "dtype", "valid-dtype",
                                   "slot", "head-dim", "contiguity"])
def test_decode_wrapper_rejects_what_the_kernel_does_not_take(fault):
    c = ring_case(0, 2, 8, 1, 4)
    q = _t(c["q"]).reshape(2, KV, G, HD)
    args = [q, _t(c["k_new"]), _t(c["v_new"]), _t(c["k_cache"]),
            _t(c["v_cache"]), _t(c["valid"]), c["slot"]]
    if fault == "shape":
        args[1] = args[1][:1]
    elif fault == "dtype":
        args = [a.double() if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args]
    elif fault == "valid-dtype":
        args[5] = args[5].long()
    elif fault == "slot":
        args[6] = 8
    elif fault == "head-dim":
        args[0] = torch.zeros(2, KV, G, 48)
    elif fault == "contiguity":
        args[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        ds.decode_step(*args)


@pytest.mark.parametrize("fault", ["device", "tables-dtype", "pos-shape"])
def test_paged_wrapper_rejects_what_the_kernel_does_not_take(fault):
    c = paged_case(0, 1)
    args = [_t(c["q"]).reshape(1, 5, KV, G, HD), _t(c["k_new"]),
            _t(c["v_new"]), _t(c["k_pages"]), _t(c["v_pages"]),
            _t(c["tables"]), _t(c["pos"])]
    if fault == "tables-dtype":
        args[5] = args[5].long()
    elif fault == "pos-shape":
        args[6] = args[6][:3]
    with pytest.raises(ValueError):
        ds.paged_decode_step(*args)


# ---------------------------------------------------------------------------
# the chain axis: C chains against each chain alone (C = 1)
# ---------------------------------------------------------------------------
from repro_torch.core import delay as tdelay  # noqa: E402
from repro_torch.kernels import delay_gather as dg  # noqa: E402
from repro_torch.kernels import langevin_update as lu  # noqa: E402
from repro_torch.kernels import rng  # noqa: E402

CHAIN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}


def _chain_ring(C, depth, n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(C, depth, n, generator=g)
    h.view(-1)[:3] = torch.tensor([-0.0, float("inf"), float("nan")])[: min(3, h.numel())]
    return (h.nan_to_num(0, 9, -9) * 100).to(dtype) if dtype == torch.int32 else h.to(dtype)


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.dtype != torch.bool else t


@pytest.mark.parametrize("C", [1, 3, 32])
@pytest.mark.parametrize("n", [5, 1003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_chain_update_is_the_single_update_chain_by_chain(C, n, dtype):
    """Bitwise: chain c of the plain update of C chains is the plain update
    of chain c alone (C = 1) under its seed, gamma and scale."""
    g = torch.Generator().manual_seed(C * n)
    x = torch.randn(C, n, generator=g).to(dtype)
    grad = torch.randn(C, n, generator=g).to(dtype)
    seeds = [rng.split((C, n), C)[c] for c in range(C)]
    gammas = np.linspace(1e-3, 5e-2, C).astype(np.float32)
    scales = np.linspace(0.0, 0.3, C).astype(np.float32)
    got = ref.langevin_update_ref(x.clone(), grad, seeds, gammas, scales)
    for c in range(C):
        want = ref.langevin_update_ref(x[c:c + 1].clone(), grad[c:c + 1], [seeds[c]],
                                       [gammas[c]], [scales[c]])
        assert torch.equal(_bits(got[c]), _bits(want[0])), c


@pytest.mark.parametrize("C", [1, 3, 32])
@pytest.mark.parametrize("n", [5, 1003])
@pytest.mark.parametrize("name", list(CHAIN_DTYPES))
def test_plain_chain_reads_are_the_single_reads_chain_by_chain(C, n, name):
    """Bitwise, ``-0.0``, ``inf`` and ``nan`` included: the draw, gather and
    one-pass read of C chains against those of each chain alone (C = 1),
    each chain at its own key, maxval (1 .. depth) and ring head."""
    depth = 4
    heads = [(2 + 3 * c) % depth for c in range(C)]
    h = _chain_ring(C, depth, n, CHAIN_DTYPES[name], seed=C + n)
    keys = rng.split((7, C), C)
    maxvals = [1 + c % depth for c in range(C)]
    d = ref.coordinate_delays_ref(keys, n, maxvals)
    assert d.shape == (C, n) and d.dtype == torch.int32
    read = ref.wicon_read_ref(h, keys, maxvals, heads)
    any_d = d * 3 - 5  # out-of-range delays: the slot is taken mod depth
    gather = ref.delay_gather_ref(h, any_d, heads)
    for c in range(C):
        one = slice(c, c + 1)
        assert torch.equal(d[c], ref.coordinate_delays_ref([keys[c]], n, [maxvals[c]])[0])
        assert torch.equal(_bits(read[c]), _bits(ref.wicon_read_ref(
            h[one], [keys[c]], [maxvals[c]], [heads[c]])[0]))
        assert torch.equal(_bits(gather[c]),
                           _bits(ref.delay_gather_ref(h[one], any_d[one], [heads[c]])[0]))
        slots = torch.remainder(heads[c] - any_d[c].long(), depth)
        assert torch.equal(_bits(gather[c]), _bits(h[c, slots, torch.arange(n)]))


def test_chain_ops_on_cpu_route_to_the_plain_versions():
    """The ops over a two-leaf tree (5 elements and 3 x 7) on CPU tensors:
    the commit and reads of C chains equal those of each chain alone (C =
    1), bit for bit, and launch nothing."""
    C = 3
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(C, 5, generator=g), "b": torch.randn(C, 3, 7, generator=g)}
    grads = {"a": torch.randn(C, 5, generator=g), "b": torch.randn(C, 3, 7, generator=g)}
    seeds = [(c, 99) for c in range(C)]
    gammas, scales = [np.float32(1e-2)] * C, [np.float32(0.1 * c) for c in range(C)]
    want = [ops.fused_langevin_update({k: v[c:c + 1].clone() for k, v in params.items()},
                                      {k: v[c:c + 1] for k, v in grads.items()},
                                      [seeds[c]], [gammas[c]], [scales[c]])
            for c in range(C)]
    counts = (lu.langevin_update.launches, dg.wicon_read.launches)
    ops.fused_langevin_update(params, grads, seeds, gammas, scales)
    for c in range(C):
        for k in params:
            assert torch.equal(params[k][c], want[c][k][0])
    ring = tdelay.RingBuffer(history={k: torch.randn(C, 4, *v.shape[1:], generator=g)
                                      for k, v in params.items()},
                             head=torch.tensor([1] * C), depth=4)
    keys, delays = rng.split((5, 5), C), [0, 2, 7]
    for fused in (False, True):
        got = tdelay.read_inconsistent_leafwise(ring, keys, delays, fused=fused)
        for c in range(C):
            one = tdelay.RingBuffer({k: v[c:c + 1] for k, v in ring.history.items()},
                                    torch.tensor([1]), 4)
            want = tdelay.read_inconsistent_leafwise(one, [keys[c]], [delays[c]],
                                                     fused=fused)
            for k in params:
                assert torch.equal(got[k][c], want[k][0])
    same = tdelay.read_consistent(ring, [1, 1, 1])
    assert same["a"].data_ptr() == ring.history["a"][:, 0].data_ptr()  # a view
    mixed = tdelay.read_consistent(ring, delays)
    for c in range(C):
        one = tdelay.RingBuffer({k: v[c:c + 1] for k, v in ring.history.items()},
                                torch.tensor([1]), 4)
        assert torch.equal(mixed["b"][c], tdelay.read_consistent(one, [delays[c]])["b"][0])
    assert counts == (lu.langevin_update.launches, dg.wicon_read.launches)


def test_chain_tables_encode_each_chains_parameters():
    rows = lu.chain_rows([(1, 2), (2**32 - 1, 0)], [np.float32(0.5), np.float32(1e-3)],
                         [np.float32(0.0), np.float32(3.0)])
    assert rows.dtype == np.uint32 and rows.shape == (2, 5)
    assert rows[1, 0] == 2**32 - 1 and rows[1, 1] == 0
    assert rows[:, 2].view(np.float32).tolist() == [0.5, np.float32(1e-3)]
    assert rows[:, 4].tolist() == [0, 0]  # no chain skipped
    skipped = lu.chain_rows([(1, 2), (3, 4)], [0.5, 0.5], [0.0, 0.0], skip=[True, False])
    assert skipped[:, 4].tolist() == [1, 0]
    t = dg.randint_rows([(3, 4), (5, 6)], [3, 1], heads=[2, 0])
    for row, key, m, head in zip(t, [(3, 4), (5, 6)], [3, 1], [2, 0]):
        k_hi, k_lo, span, mult = rng.randint_params(key, m)
        magic = rng.fastmod_magic(span)
        assert row.tolist() == [*k_hi, *k_lo, span, mult, magic & 0xFFFFFFFF,
                                magic >> 32, head]
    with pytest.raises(ValueError, match="maxval"):
        dg.randint_rows([(1, 1)], [0])


def test_chain_kernels_refuse_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        lu.langevin_update(x, x, torch.zeros(2, 4, dtype=torch.int32))
    h = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        dg.wicon_read(h, torch.zeros(2, 9, dtype=torch.int32), [1, 1], [0, 0])
    with pytest.raises(ValueError, match="CUDA"):
        dg.delay_gather(h, torch.zeros(2, 8, dtype=torch.int32), [0, 0])
    with pytest.raises(ValueError, match="CUDA"):
        dg.coordinate_delays(torch.zeros(2, 9, dtype=torch.int32), 8, [1, 1])
    with pytest.raises(TypeError, match=r"\(C,\) head tensor"):  # one head a chain
        tdelay.push(tdelay.RingBuffer({"a": h}, np.int32(0), 3), {"a": x})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_update_skips_rows_and_flags_nonfinite_chains(dtype):
    """A skipped chain's row is bitwise untouched, a NaN gradient
    included; kept rows are bitwise the unmasked update; the flags mark
    exactly the kept chains whose new row holds a NaN or Inf, and equal
    ``torch.isfinite`` on the output."""
    C, n = 5, 1003
    g = torch.Generator().manual_seed(3)
    x = torch.randn(C, n, generator=g).to(dtype)
    grad = torch.randn(C, n, generator=g).to(dtype)
    grad[1, 7] = float("nan")   # skipped: never read
    grad[2, 500] = float("nan")  # kept: its row goes non-finite
    grad[4, 0] = float("inf")
    seeds = rng.split((C, n), C)
    gammas = np.full(C, 1e-2, np.float32)
    scales = np.linspace(0.0, 0.3, C).astype(np.float32)
    skip = np.array([False, True, False, True, False])
    want = ref.langevin_update_ref(x.clone(), grad, seeds, gammas, scales)
    flags = torch.zeros(C, dtype=torch.int32)
    got = ref.langevin_update_ref(x.clone(), grad, seeds, gammas, scales, skip, flags)
    for c in range(C):
        assert torch.equal(_bits(got[c]), _bits(x[c] if skip[c] else want[c])), c
    assert flags.tolist() == [0, 0, 1, 0, 1]
    expect = (~torch.isfinite(got).all(dim=1)).to(torch.int32)
    assert torch.equal(flags, expect * torch.from_numpy(~skip).to(torch.int32))
    # ops route the same masks through the tree op, flags OR'd over leaves
    params = {"a": x[:, :3].clone(), "b": x[:, 3:].clone()}
    grads = {"a": grad[:, :3].contiguous(), "b": grad[:, 3:].contiguous()}
    flags = torch.zeros(C, dtype=torch.int32)
    ops.fused_langevin_update(params, grads, seeds, gammas, scales, skip, flags)
    assert flags.tolist() == [0, 0, 1, 0, 1]
    for c in np.flatnonzero(skip):
        assert torch.equal(_bits(params["b"][c]), _bits(x[c, 3:]))


def test_ring_push_keeps_masked_chains_and_reads_from_each_head():
    """``push(keep=)`` writes and advances only the kept chains; the reads
    then take each chain's slot from its own head."""
    C, depth = 3, 4
    ring = tdelay.init_ring({"w": torch.zeros(5)}, depth - 1)
    assert ring.head.shape == ()
    ring = tdelay.RingBuffer({"w": torch.stack([ring.history["w"]] * C)},
                             torch.zeros(C, dtype=torch.int64), depth)
    for k in range(1, 4):
        x = {"w": torch.full((C, 5), float(k)) + torch.arange(C)[:, None] * 10}
        ring = tdelay.push(ring, x, keep=np.array([True, k != 2, k == 3]))
    assert tdelay.heads(ring) == [3, 2, 1]
    assert ring.history["w"][0, 1:, 0].tolist() == [1.0, 2.0, 3.0]
    assert ring.history["w"][1, 1:3, 0].tolist() == [11.0, 13.0]
    assert ring.history["w"][2, 1, 0] == 23.0 and ring.history["w"][2, 2:, 0].sum() == 0
    newest = tdelay.read_consistent(ring, [0, 0, 0])["w"][:, 0]
    assert newest.tolist() == [3.0, 13.0, 23.0]
    keys = rng.split((1, 2), C)
    got = tdelay.read_inconsistent_leafwise(ring, keys, [0, 0, 0], fused=True)
    assert torch.equal(got["w"][:, 0], newest)
