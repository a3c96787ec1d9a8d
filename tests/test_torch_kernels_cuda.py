"""The CUDA decode kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false
(the kernels have no CPU mode).  This file imports no JAX, so it runs on a
machine without it::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes are qwen3-4b's (8 KV heads, 4 query heads each, head_dim 128).
Outputs agree to 1e-5 in float32 (same op order, summation order differs)
and to 2e-2 in bf16 (one bf16 ulp of |o| <= 4: both round the same fp32
result, which may sit on either side of a rounding boundary); caches and
pools are equal bit for bit outside the garbage row.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_step as ds
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
