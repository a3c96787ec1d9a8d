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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
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
