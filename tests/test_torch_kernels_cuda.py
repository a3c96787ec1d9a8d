"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false
(the kernels have no CPU mode).  This file imports no JAX, so it runs on a
machine without it::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Decode steps: qwen3-4b's shapes (8 KV heads, 4 query heads each,
head_dim 128).  Outputs agree to 1e-5 in float32 (same op order,
summation order differs) and to 2e-2 in bf16 (one bf16 ulp of |o| <= 4:
both round the same fp32 result, which may sit on either side of a
rounding boundary); caches and pools are equal bit for bit outside the
garbage row.

SGLD kernels, at ragged lengths: the Langevin update agrees with its plain
version within 2e-6 in float32 and one bf16 ulp in bfloat16 (same bits
and the same fused multiply-adds; the plain version's float64 emulation
of an fma and CUDA's logf/cosf against ATen's may differ in the last
float32 ulp); the delay draw and the gather are equal bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_step as ds
from repro_torch.kernels import delay_gather as dg
from repro_torch.kernels import langevin_update as lu
from repro_torch.kernels import ref
from torch_cases import RING_CASES, RING_IDS, assert_pool_equal, paged_case, ring_case


def _np(t):
    return t.detach().cpu().numpy()


def _t(a, device, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RING_CASES, ids=RING_IDS)
def test_decode_kernel_matches_plain_on_card(cuda, dtype, case):
    c = ring_case(**case, kv=8, g=4, hd=128)
    t = {k: _t(v, cuda, dtype if v.dtype == np.float32 else None)
         for k, v in c.items() if k != "slot"}
    q = t["q"].reshape(-1, 8, 4, 128)
    plain = [x.clone() for x in (t["k_cache"], t["v_cache"])]
    o, kc, vc = ds.decode_step(q, t["k_new"], t["v_new"], t["k_cache"],
                               t["v_cache"], t["valid"], c["slot"])
    want, wk, wv = ref.decode_step_ref(q, t["k_new"], t["v_new"], *plain,
                                       t["valid"], c["slot"])
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), want.float(), rtol=0,
                               atol=KERNEL_TOL[dtype])
    assert torch.equal(kc, wk) and torch.equal(vc, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_kernel_matches_plain_on_card(cuda, dtype):
    c = paged_case(11, 2, kv=8, g=4, hd=128)
    t = {k: _t(v, cuda, dtype if v.dtype == np.float32 else None)
         for k, v in c.items()}
    q = t["q"].reshape(2, 5, 8, 4, 128)
    plain = [x.clone() for x in (t["k_pages"], t["v_pages"])]
    o, kp, vp = ds.paged_decode_step(q, t["k_new"], t["v_new"], t["k_pages"],
                                     t["v_pages"], t["tables"], t["pos"])
    want, wk, wv = ref.paged_decode_step_ref(q, t["k_new"], t["v_new"], *plain,
                                             t["tables"], t["pos"])
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), want.float(), rtol=0,
                               atol=KERNEL_TOL[dtype])
    ps = c["k_pages"].shape[2]
    rows = c["tables"][np.arange(5), c["pos"] // ps] * ps + c["pos"] % ps
    shared = {0: [3, 4]}
    new_k = _np(t["k_new"].float())
    new_v = _np(t["v_new"].float())
    assert_pool_equal(_np(kp.float()), _np(wk.float()), shared, new_k, ps)
    assert_pool_equal(_np(vp.float()), _np(wv.float()), shared, new_v, ps)
    assert rows[3] == rows[4] == 0


# ---------------------------------------------------------------------------
# SGLD kernels
# ---------------------------------------------------------------------------
def _within_bf16_ulp(got, want):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= want.abs() * 2.0**-7 + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 4096, 1_000_003])
def test_langevin_kernel_matches_plain_on_card(cuda, dtype, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, generator=gen, device=cuda).to(dtype)
    g = torch.randn(n, generator=gen, device=cuda).to(dtype)
    seed, gamma, scale = (0x1234ABCD, 77), np.float32(1e-3), np.float32(0.03)
    want = ref.langevin_update_ref(x.clone(), g, seed, gamma, scale)
    before = lu.langevin_update.launches
    got = lu.langevin_update(x, g, seed, gamma, scale)
    torch.cuda.synchronize()
    assert got is x and lu.langevin_update.launches == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    else:
        assert _within_bf16_ulp(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_langevin_kernel_noise_is_the_plain_noise(cuda, dtype):
    """gamma = 0, x = 0, scale = 1: the output is the noise itself."""
    n = 1_000_003
    g = torch.ones(n, device=cuda, dtype=dtype)
    x = torch.zeros(n, device=cuda, dtype=dtype)
    lu.langevin_update(x, g, (5, 6), np.float32(0), np.float32(1))
    want = ref.langevin_update_ref(torch.zeros_like(x), g, (5, 6),
                                   np.float32(0), np.float32(1))
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(x, want, rtol=0, atol=2e-6)
    else:
        assert _within_bf16_ulp(x, want)
    assert abs(float(x.float().mean())) < 5e-3
    assert abs(float(x.float().std()) - 1.0) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("maxval", [1, 2, 3])
def test_coordinate_delays_kernel_equals_plain_on_card(cuda, maxval):
    n = 1_000_003
    got = dg.coordinate_delays((123, 456), n, maxval, cuda)
    want = ref.coordinate_delays_ref((123, 456), n, maxval, cuda)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got.min()) == 0 and int(got.max()) == maxval - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32],
                         ids=["f32", "bf16", "i32"])
def test_delay_gather_kernel_equals_plain_on_card(cuda, dtype):
    depth, n, head = 3, 1_000_003, 2
    gen = torch.Generator(device=cuda).manual_seed(3)
    h = torch.randn(depth, n, generator=gen, device=cuda)
    if dtype == torch.int32:
        h = (h * 1000).to(torch.int32)
    else:
        h[0, :4] = torch.tensor([-0.0, float("inf"), float("nan"), -0.0])
        h = h.to(dtype)
    delays = torch.randint(0, depth, (n,), generator=gen, device=cuda,
                           dtype=torch.int32)
    before = dg.delay_gather.launches
    got = dg.delay_gather(h, delays, head)
    want = ref.delay_gather_ref(h, delays, head)
    torch.cuda.synchronize()
    assert dg.delay_gather.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
