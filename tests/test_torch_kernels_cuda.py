"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false
(the kernels have no CPU mode).  This file imports no JAX, so it runs on a
machine without it::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Decode steps: qwen3-4b's shapes (8 KV heads, 4 query heads each,
head_dim 128), at the small shared cases and at the cases the split-KV
plan makes hard (full 1024- and 16,384-slot rings, whole empty splits, a
ring where only the slot is valid or nothing is, paged positions on chunk
and page boundaries, position 0, the garbage page, 4,096-position windows,
a page id outside the pool), and at the shapes a rank of the model axis
gives them (4 KV heads at G 4, and one KV head at G 2: a K/V-replicated
slice; head_dim 128).  Outputs agree to 1e-5 in float32 (same op
order, summation order differs) and in bf16 to 2e-2 (one bf16 ulp of
|o| <= 4: the kernel's fp32 result, from tensor-core products with the
weights kept to ~16 bits, differs from the plain step's by ~1e-5 and may
round to the other side of a boundary) and to two bf16 ulps of the largest
plain output (a long context's output is small, |o| ~ sqrt(e / n), where
2e-2 alone would pass a kernel that dropped a split); caches and pools are
equal bit for bit outside the garbage row, and two calls give the same
bits.

SGLD kernels (each takes chains on a leading axis; one chain is C = 1),
at ragged lengths: the Langevin update agrees with its plain
version within 2e-6 in float32 and one bf16 ulp in bfloat16 (same bits
and the same fused multiply-adds; the plain version's float64 emulation
of an fma and CUDA's logf/cosf against ATen's may differ in the last
float32 ulp), on its vector code (16-byte aligned, a tail of 1-7
elements) and its scalar code (a tensor one element off 16 bytes); the
delay draw, the gather (out-of-range delays included) and the one-pass
W-Icon read are equal bit for bit, the read on aligned rows (vectors) and
on misaligned ones (scalar code) over rings of depth 1-5; the draw and
the read of one chain of 2^32 + 2^20 elements (the 64-bit index path,
counters with a high word) equal the plain draw at their counters, and
the fused update still refuses a chain past 2^32.

One launch for C chains: chain c is bit for bit the same kernel on chain
c alone (C = 1, an aligned copy) with its parameters, and agrees with the
plain version (the update within 2e-6 / one bf16 ulp, the draw, gather
and read bit for bit), at C 1, 3 and 32, on rows that start off 16 bytes
(odd sizes), on aligned ones, and with x and g off 16 bytes by different
amounts (the update's all-scalar rows); an op launches each kernel once a
leaf whatever C is, and its per-commit tables reach the card without
stalling the host.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import delay as tdelay
from repro_torch.kernels import decode_step as ds
from repro_torch.kernels import delay_gather as dg
from repro_torch.kernels import langevin_update as lu
from repro_torch.kernels import ops, ref, rng
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


def _decode_limit(want, dtype):
    """Per row or slot (over its KV heads x G x hd outputs): KERNEL_TOL, and
    in bf16 also two bf16 ulps of the row's largest |want|."""
    tol = torch.full((*want.shape[:-3], 1, 1, 1), KERNEL_TOL[dtype],
                     device=want.device)
    if dtype != torch.bfloat16:
        return tol
    m = want.float().abs().amax(dim=(-3, -2, -1), keepdim=True)
    return torch.where(m > 0, torch.minimum(tol, torch.exp2(torch.floor(torch.log2(m)) - 6)), tol)


def _within(got, want, limit):
    return bool(((got.float() - want.float()).abs() <= limit).all())


def _assert_decode_close(got, want, dtype):
    limit = _decode_limit(want, dtype)
    err = (got.float() - want.float()).abs().max().item()
    assert _within(got, want, limit), (err, limit.min().item())


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
    _assert_decode_close(o, want, dtype)
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
    _assert_decode_close(o, want, dtype)
    ps = c["k_pages"].shape[2]
    rows = c["tables"][np.arange(5), c["pos"] // ps] * ps + c["pos"] % ps
    shared = {0: [3, 4]}
    new_k = _np(t["k_new"].float())
    new_v = _np(t["v_new"].float())
    assert_pool_equal(_np(kp.float()), _np(wk.float()), shared, new_k, ps)
    assert_pool_equal(_np(vp.float()), _np(wv.float()), shared, new_v, ps)
    assert rows[3] == rows[4] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RING_CASES, ids=RING_IDS)
def test_decode_kernel_at_group_3_matches_plain_on_card(cuda, dtype, case):
    """12 query heads over 4 KV heads, head_dim 64 (the 110M example
    model): a group that is no power of two."""
    c = ring_case(**case, kv=4, g=3, hd=64)
    t = {k: _t(v, cuda, dtype if v.dtype == np.float32 else None)
         for k, v in c.items() if k != "slot"}
    q = t["q"].reshape(-1, 4, 3, 64)
    plain = [x.clone() for x in (t["k_cache"], t["v_cache"])]
    o, kc, vc = ds.decode_step(q, t["k_new"], t["v_new"], t["k_cache"],
                               t["v_cache"], t["valid"], c["slot"])
    want, wk, wv = ref.decode_step_ref(q, t["k_new"], t["v_new"], *plain,
                                       t["valid"], c["slot"])
    torch.cuda.synchronize()
    _assert_decode_close(o, want, dtype)
    assert torch.equal(kc, wk) and torch.equal(vc, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pos,maxp", [([40, 95, 130, 7, None], 16),
                                      ([1000, 17, None, 600], 64)],
                         ids=["cell", "long"])
def test_paged_kernel_at_group_3_matches_plain_on_card(cuda, dtype, pos, maxp):
    q, kn, vn, kp, vp, tables, pos_t = _paged(cuda, dtype, pos, ps=16, maxp=maxp,
                                              KV=4, G=3, hd=64)
    plain = [x.clone() for x in (kp, vp)]
    o, _, _ = ds.paged_decode_step(q, kn, vn, kp, vp, tables, pos_t)
    want = ref.paged_decode_step_ref(q, kn, vn, *plain, tables, pos_t)[0]
    torch.cuda.synchronize()
    _assert_decode_close(o, want, dtype)


# (KV heads, query heads a KV head, head_dim) the model zoo adds: kimi-k2's
# head_dim 112 at G 8 and stablelm-12b's 160 at G 4 (rows of 14 or 20 bf16
# copies, which do not divide the block; 7 or 10 mma row tiles over 4
# warps), internvl2-1b's group of 7 and hymba-1.5b's group of 5 at
# head_dim 64
NEW_SHAPES = {"hd112-g8": (8, 8, 112), "hd160-g4": (8, 4, 160),
              "hd64-g7": (2, 7, 64), "hd64-g5": (5, 5, 64)}
# the shapes a rank of the model axis gives the kernels: qwen3-4b's (and
# phi3.5-moe's) 8 KV heads split over model 2 (4 KV heads, G 4, head_dim
# 128), and a K/V-replicated slice (qwen3-4b at model 16: a rank's 2 query
# heads read one KV head, G 2 from G 4)
LOCAL_SHAPES = {"local-kv4-g4": (4, 4, 128), "local-kv1-g2": (1, 2, 128)}
SHAPES = {**NEW_SHAPES, **LOCAL_SHAPES}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("case", RING_CASES + [dict(seed=3, N=2, smax=1024,
                                                    slot=1000, n_valid=1024)],
                         ids=RING_IDS + ["full-1024"])
def test_decode_kernel_at_new_shapes_matches_plain_on_card(cuda, dtype, shape, case):
    kv, g, hd = SHAPES[shape]
    c = ring_case(**case, kv=kv, g=g, hd=hd)
    t = {k: _t(v, cuda, dtype if v.dtype == np.float32 else None)
         for k, v in c.items() if k != "slot"}
    q = t["q"].reshape(-1, kv, g, hd)
    plain = [x.clone() for x in (t["k_cache"], t["v_cache"])]
    o, kc, vc = ds.decode_step(q, t["k_new"], t["v_new"], t["k_cache"],
                               t["v_cache"], t["valid"], c["slot"])
    want, wk, wv = ref.decode_step_ref(q, t["k_new"], t["v_new"], *plain,
                                       t["valid"], c["slot"])
    torch.cuda.synchronize()
    _assert_decode_close(o, want, dtype)
    assert torch.equal(kc, wk) and torch.equal(vc, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("pos,maxp", [([40, 95, 130, 7, None, 255], 16),
                                      ([1000, 17, None, 600], 64)],
                         ids=["cell", "long"])
def test_paged_kernel_at_new_shapes_matches_plain_on_card(cuda, dtype, shape,
                                                          pos, maxp):
    kv, g, hd = SHAPES[shape]
    q, kn, vn, kp, vp, tables, pos_t = _paged(cuda, dtype, pos, ps=16, maxp=maxp,
                                              KV=kv, G=g, hd=hd)
    plain = [x.clone() for x in (kp, vp)]
    o, kp, vp = ds.paged_decode_step(q, kn, vn, kp, vp, tables, pos_t)
    want, wk, wv = ref.paged_decode_step_ref(q, kn, vn, *plain, tables, pos_t)
    torch.cuda.synchronize()
    _assert_decode_close(o, want, dtype)
    assert torch.isfinite(o.float()).all()
    for got, exp in ((kp, wk), (vp, wv)):  # one inactive slot: no race
        assert torch.equal(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("G,hd", [(6, 64), (4, 96)])
def test_uncompiled_shapes_raise_on_card(cuda, G, hd):
    """Group 6 and head_dim 96 are not compiled: both wrappers raise on
    the card's tensors, before any launch and with no plain fallback."""
    q, kn, vn, kc, vc = (torch.zeros(*s, device=cuda) for s in
                         ((2, 2, G, hd), (2, 2, hd), (2, 2, hd),
                          (2, 32, 2, hd), (2, 32, 2, hd)))
    before = ds.decode_step.launches, ds.paged_decode_step.launches
    with pytest.raises(ValueError, match="not compiled"):
        ds.decode_step(q, kn, vn, kc, vc,
                       torch.ones(32, dtype=torch.int32, device=cuda), 3)
    pages = torch.zeros(1, 9, 4, 2, hd, device=cuda)
    with pytest.raises(ValueError, match="not compiled"):
        ds.paged_decode_step(q[None], kn[None], vn[None], pages, pages.clone(),
                             torch.zeros(2, 4, dtype=torch.int32, device=cuda),
                             torch.zeros(2, dtype=torch.int32, device=cuda))
    assert (ds.decode_step.launches, ds.paged_decode_step.launches) == before


# ---------------------------------------------------------------------------
# the split-KV decode kernels at the cases their plan makes hard
# ---------------------------------------------------------------------------
def _ring(cuda, dtype, N, smax, slot, valid_rows, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda).to(dtype)  # noqa: E731
    valid = torch.zeros(smax, dtype=torch.int32, device=cuda)
    valid[valid_rows] = 1
    return (r(N, 8, 4, 128), r(N, 8, 128), r(N, 8, 128), r(N, smax, 8, 128),
            r(N, smax, 8, 128), valid, slot)


def _ring_check(args, dtype):
    q, kn, vn, kc, vc, valid, slot = args
    plain = [x.clone() for x in (kc, vc)]
    before = ds.decode_step.launches
    o, kc2, vc2 = ds.decode_step(q, kn, vn, kc, vc, valid, slot)
    want, wk, wv = ref.decode_step_ref(q, kn, vn, *plain, valid, slot)
    torch.cuda.synchronize()
    assert ds.decode_step.launches == before + 1
    assert torch.isfinite(o.float()).all()
    _assert_decode_close(o, want, dtype)
    assert torch.equal(kc2, wk) and torch.equal(vc2, wv)
    return o


RING_SPLIT_CASES = {
    # smax, slot, valid rows: a full 1024-slot ring (16 splits of 64)
    "full-1024": (1024, 1000, slice(None)),
    # a 16,384-slot ring, which the kernel refused before it was split
    "full-16384": (16384, 9000, slice(None)),
    # valid rows in splits 0 and 15 only: splits 1-14 are empty
    "empty-splits": (1024, 1020, [0, 5, 63, 1000, 1023]),
    # only the slot is valid
    "only-slot-1024": (1024, 517, [517]),
    # the decode cell's shape: 48 valid rows of 256, splits 2-7 empty
    "decode-cell": (256, 47, slice(0, 48)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(RING_SPLIT_CASES))
def test_split_ring_kernel_matches_plain_on_card(cuda, dtype, case):
    smax, slot, rows = RING_SPLIT_CASES[case]
    N = 2 if smax > 4096 else 4
    _ring_check(_ring(cuda, dtype, N, smax, slot, rows, seed=smax), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["full-1024", "full-16384"])
def test_decode_limit_sees_a_dropped_split(cuda, dtype, case):
    """The kernel's output is within the limit; the plain step with split
    0's positions masked off is not (the slot stays valid)."""
    smax, slot, rows = RING_SPLIT_CASES[case]
    args = _ring(cuda, dtype, 2, smax, slot, rows, seed=smax)
    o = _ring_check(args, dtype)
    q, kn, vn, kc, vc, valid, _ = args
    chunk = ds.ring_plan(smax)[1]
    drop = valid.clone()
    drop[:chunk] = 0
    drop[slot] = 1
    full = ref.decode_step_ref(q, kn, vn, kc.clone(), vc.clone(), valid, slot)[0]
    off = ref.decode_step_ref(q, kn, vn, kc.clone(), vc.clone(), drop, slot)[0]
    limit = _decode_limit(full, dtype)
    assert _within(o, full, limit)
    assert not _within(off, full, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_ring_kernel_with_nothing_valid_matches_plain(cuda, dtype):
    """No position valid, not even the slot: the plain step weighs every
    position equally, and so does the kernel's last block."""
    _ring_check(_ring(cuda, dtype, 2, 256, 9, []), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_kernels_are_bitwise_repeatable(cuda, dtype):
    """Splits merge in a fixed order: two calls give the same bits."""
    q, kn, vn, kc, vc, valid, slot = _ring(cuda, dtype, 4, 1024, 3, slice(None))
    a = ds.decode_step(q, kn, vn, kc, vc, valid, slot)[0].clone()
    b = ds.decode_step(q, kn, vn, kc, vc, valid, slot)[0]
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    args = _paged(cuda, dtype, [255, 40, 0, 17], ps=16, maxp=16)
    a = ds.paged_decode_step(*args)[0].clone()
    b = ds.paged_decode_step(*args)[0]
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _paged(cuda, dtype, pos, *, ps, maxp, C=2, seed=1, KV=8, G=4, hd=128):
    """Slots at ``pos`` on a permuted page table (None: inactive, table row
    0 and position 0, the garbage page)."""
    S = len(pos)
    n_pages = S * maxp + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    tables = torch.zeros(S, maxp, dtype=torch.int32)
    nxt = 0
    for s, p in enumerate(pos):
        if p is not None:
            tables[s, :p // ps + 1] = perm[nxt:nxt + p // ps + 1]
            nxt += p // ps + 1
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda).to(dtype)  # noqa: E731
    return (r(C, S, KV, G, hd), r(C, S, KV, hd), r(C, S, KV, hd),
            r(C, n_pages, ps, KV, hd), r(C, n_pages, ps, KV, hd),
            tables.to(cuda),
            torch.tensor([p or 0 for p in pos], dtype=torch.int32, device=cuda))


PAGED_SPLIT_CASES = {
    # 16 pages of 16, 16 splits of one page: positions on a chunk boundary
    # (the first row of a split's page), the last row of a chunk, and the
    # longest slot
    "chunk-boundary": ([16, 31, 32, 255], 16, 16),
    # 64 pages of 4, 16 splits of up to 4 pages: page boundaries inside a
    # chunk
    "page-boundary": ([4, 7, 8, 100, 255], 4, 64),
    # position 0 only, and inactive slots on the garbage page
    "pos-0": ([0, 0, 0], 16, 16),
    "garbage-page": ([None, 200, None, 3, None], 16, 16),
    # 4,096-position windows: maxp 256, positions spread over the window
    "window-4096": ([4095, 2048, 17, None, 3000, 1023, None, 600], 16, 256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
def test_split_paged_kernel_matches_plain_on_card(cuda, dtype, case):
    pos, ps, maxp = PAGED_SPLIT_CASES[case]
    q, kn, vn, kp, vp, tables, pos_t = _paged(cuda, dtype, pos, ps=ps, maxp=maxp)
    plain = [x.clone() for x in (kp, vp)]
    o, kp, vp = ds.paged_decode_step(q, kn, vn, kp, vp, tables, pos_t)
    want, wk, wv = ref.paged_decode_step_ref(q, kn, vn, *plain, tables, pos_t)
    torch.cuda.synchronize()
    _assert_decode_close(o, want, dtype)
    writers = [s for s, p in enumerate(pos) if p is None or p == 0
               and int(tables[s, 0]) == 0]
    shared = {0: writers} if len(writers) > 1 else {}
    assert_pool_equal(_np(kp.float()), _np(wk.float()), shared,
                      _np(kn.float()), ps)
    assert_pool_equal(_np(vp.float()), _np(wv.float()), shared,
                      _np(vn.float()), ps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_paged_kernel_refuses_a_page_outside_the_pool(cuda, dtype):
    """A page id outside the pool: that slot's output is NaN and nothing is
    stored for it; the other slots are unaffected."""
    q, kn, vn, kp, vp, tables, pos = _paged(cuda, dtype, [40, 100, 7], ps=16,
                                           maxp=16)
    n_pages = kp.shape[1]
    tables[1, 3] = n_pages  # one past the pool, on a page slot 1 attends to
    before_k, before_v = kp.clone(), vp.clone()
    o, kp, vp = ds.paged_decode_step(q, kn, vn, kp, vp, tables, pos)
    torch.cuda.synchronize()
    assert torch.isnan(o[:, 1].float()).all()
    assert torch.isfinite(o[:, [0, 2]].float()).all()
    row1 = int(tables[1, 100 // 16]) * 16 + 100 % 16
    flat = lambda t: t.reshape(t.shape[0], -1, 8, 128)  # noqa: E731
    assert torch.equal(flat(kp)[:, row1], flat(before_k)[:, row1])
    assert torch.equal(flat(vp)[:, row1], flat(before_v)[:, row1])
    # the good slots stored their rows and match the plain step
    t2 = tables.clone()
    t2[1, 3] = 0
    want = ref.paged_decode_step_ref(q, kn, vn, before_k.clone(),
                                     before_v.clone(), t2, pos)[0]
    _assert_decode_close(o[:, [0, 2]], want[:, [0, 2]], dtype)


@pytest.mark.cuda
def test_split_shared_memory_mirror_matches_the_source(cuda):
    """decode_step.smem_bytes (used by the CPU plan tests and the wrapper's
    check) equals the source's own layout."""
    for elem, dtype in ((2, torch.bfloat16), (4, torch.float32)):
        lib = ds._lib(dtype)
        for hd in ds._HEAD_DIMS:
            for G in ds._GROUPS:
                for pages in (0, 1, 16, 128):
                    assert lib.decode_step_smem_bytes(G, hd, elem, pages) == \
                        ds.smem_bytes(G, hd, elem, pages)


# ---------------------------------------------------------------------------
# SGLD kernels (each takes chains on a leading axis; one chain is C = 1)
# ---------------------------------------------------------------------------
def _within_bf16_ulp(got, want):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= want.abs() * 2.0**-7 + 1e-30).all())


def _table(rows, device):
    return torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)).to(device)


def _update_one(x, g, seed, gamma, scale):
    """The update kernel on one chain (C = 1), in place on x."""
    table = _table(lu.chain_rows([seed], [gamma], [scale]), x.device)
    return lu.langevin_update(x[None], g[None], table)[0]


def _update_ref_one(x, g, seed, gamma, scale):
    return ref.langevin_update_ref(x[None], g[None], [seed], [gamma], [scale])[0]


def _draw_table(key, maxval, device, head=0):
    return _table(dg.randint_rows([key], [maxval], [head]), device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 4096, 1_000_003])
def test_langevin_kernel_matches_plain_on_card(cuda, dtype, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, generator=gen, device=cuda).to(dtype)
    g = torch.randn(n, generator=gen, device=cuda).to(dtype)
    seed, gamma, scale = (0x1234ABCD, 77), np.float32(1e-3), np.float32(0.03)
    want = _update_ref_one(x.clone(), g, seed, gamma, scale)
    before = lu.langevin_update.launches
    got = _update_one(x, g, seed, gamma, scale)
    torch.cuda.synchronize()
    assert got.data_ptr() == x.data_ptr() and lu.langevin_update.launches == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(x, want, rtol=0, atol=2e-6)
    else:
        assert _within_bf16_ulp(x, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_langevin_kernel_noise_is_the_plain_noise(cuda, dtype):
    """gamma = 0, x = 0, scale = 1: the output is the noise itself."""
    n = 1_000_003
    g = torch.ones(n, device=cuda, dtype=dtype)
    x = torch.zeros(n, device=cuda, dtype=dtype)
    _update_one(x, g, (5, 6), np.float32(0), np.float32(1))
    want = _update_ref_one(torch.zeros_like(x), g, (5, 6), np.float32(0), np.float32(1))
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(x, want, rtol=0, atol=2e-6)
    else:
        assert _within_bf16_ulp(x, want)
    assert abs(float(x.float().mean())) < 5e-3
    assert abs(float(x.float().std()) - 1.0) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("maxval", [1, 2, 3, 5, 7, 255, 4097, 65535])
def test_coordinate_delays_kernel_equals_plain_on_card(cuda, maxval):
    """The kernel takes ``x mod maxval`` by two multiplications
    (``csrc/randint.cuh``) and skips the high stream where 2^32 mod maxval
    is 0; the plain draw takes ``%`` of both."""
    n = 1_000_003
    got = dg.coordinate_delays(_draw_table((123, 456), maxval, cuda), n, [maxval])
    want = ref.coordinate_delays_ref([(123, 456)], n, [maxval], cuda)
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
    got = dg.delay_gather(h[None], delays[None], [head])
    want = ref.delay_gather_ref(h[None], delays[None], [head])
    torch.cuda.synchronize()
    assert dg.delay_gather.launches == before + 1
    assert got.dtype == dtype and got.shape == (1, n)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_langevin_kernel_vector_and_scalar_code_match_plain(cuda, dtype, off):
    """Sizes = 1..7 mod 8 and a whole number of vectors; the tensor at
    ``off`` elements past a 16-byte boundary (off 0: the vector code and
    its tail; else the peel, the vector code and the tail)."""
    seed, gamma, scale = (0xABCDEF01, 5), np.float32(1e-2), np.float32(0.1)
    for n in [4096 + r for r in range(9)] + [1, 7]:
        gen = torch.Generator(device=cuda).manual_seed(n + off)
        x = torch.randn(off + n, generator=gen, device=cuda).to(dtype)[off:]
        g = torch.randn(off + n, generator=gen, device=cuda).to(dtype)[off:]
        want = _update_ref_one(x.clone(), g, seed, gamma, scale)
        _update_one(x, g, seed, gamma, scale)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(x, want, rtol=0, atol=2e-6)
        else:
            assert _within_bf16_ulp(x, want), n


def _ring_on(cuda, dtype, depth, n, off, seed):
    """(depth, n) ring starting ``off`` elements past an allocation (off 1:
    history misaligned), with -0.0, inf and nan among the floats."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn(off + depth * n, generator=gen, device=cuda)
    h[off:off + 4] = torch.tensor([-0.0, float("inf"), float("nan"), -0.0])[:depth * n]
    h = (h.nan_to_num(0, 9, -9) * 1000).to(dtype) if dtype == torch.int32 else h.to(dtype)
    return h[off:].view(depth, n)


def _bitwise(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32],
                         ids=["f32", "bf16", "i32"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_wicon_read_kernel_equals_plain_on_card(cuda, dtype, depth):
    """Aligned rows (the vector code; rows past 4 are gathered lane by
    lane), sizes = 1..7 mod 8 (misaligned rows: the scalar code) and a
    history one element off its allocation; every maxval, two heads."""
    for n in [4096 + r for r in range(8)]:
        for off in (0, 1):
            h = _ring_on(cuda, dtype, depth, n, off, seed=n + depth + off)[None]
            for head in sorted({0, depth - 1}):
                for maxval in range(1, depth + 1):
                    key = (n * depth + maxval, head)
                    before = dg.wicon_read.launches
                    got = dg.wicon_read(h, _draw_table(key, maxval, cuda, head), [maxval],
                                        [head])
                    want = ref.wicon_read_ref(h, [key], [maxval], [head])
                    torch.cuda.synchronize()
                    assert dg.wicon_read.launches == before + 1
                    assert got.dtype == dtype
                    assert _bitwise(got, want), (n, off, head, maxval)


#: a chain of 2^32 + 2^20 elements: its row runs the kernels' 64-bit index
#: path, and its last 2^20 draws have counters with a high word of 1
LONG_ROW = 2**32 + 2**20
#: windows of that row held against the plain draw at their counters:
#: the first elements, the 2^20 below 2^32 and the last 2^20 (above it)
LONG_WINDOWS = [(0, 2**16), (2**32 - 2**20, 2**32), (2**32, LONG_ROW)]


@pytest.mark.cuda
@pytest.mark.parametrize("maxval", [3, 4])
def test_coordinate_delays_past_2_32_equal_the_plain_draw(cuda, maxval):
    """One chain of 2^32 + 2^20 delays (17.2 GB of int32): the elements
    on both sides of 2^32 and the last 2^20 equal ``rng.randint`` at their
    counters (``start=``), where JAX's counter has a high word; both
    streams (maxval 3) and the low one alone (4)."""
    key = (0x1234, 0x5678)
    got = dg.coordinate_delays(_draw_table(key, maxval, cuda), LONG_ROW, [maxval])
    for a, b in LONG_WINDOWS:
        want = rng.randint(key, b - a, maxval, cuda, start=a)
        assert torch.equal(got[0, a:b], want), (a, b)
    del got
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_wicon_read_past_2_32_equals_the_plain_draw(cuda):
    """The one-pass read of a bfloat16 ring of depth 3 over 2^32 + 2^20
    elements (25.8 GB, and 8.6 GB out): row d holds ``i mod 64 + 64 d``
    (exact in bfloat16), so each element read names its own index and
    its slot; on the windows of :data:`LONG_WINDOWS` the slot is ``(head -
    d_i) mod 3`` with ``d`` the plain draw at those counters."""
    depth, head, maxval, key = 3, 1, 3, (0xBEEF, 0x0F0F)
    hist = torch.empty((1, depth, LONG_ROW), dtype=torch.bfloat16, device=cuda)
    tile = torch.arange(64, dtype=torch.float32, device=cuda)
    for d in range(depth):
        hist[0, d].view(-1, 64).copy_((tile + 64 * d).to(torch.bfloat16))
    got = dg.wicon_read(hist, _draw_table(key, maxval, cuda, head), [maxval], [head])
    del hist
    for a, b in LONG_WINDOWS:
        d = rng.randint(key, b - a, maxval, cuda, start=a).long()
        idx = torch.arange(a, b, device=cuda)
        want = (idx % 64 + 64 * ((head - d) % depth)).to(torch.bfloat16)
        assert torch.equal(got[0, a:b], want), (a, b)
    del got
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_the_fused_update_still_refuses_past_2_32(cuda):
    """The fused update keeps its 2^32 limit a chain: the reference's
    Pallas counter is uint32 and wraps there (a difference by design)."""
    x = torch.zeros((1, 2**32 + 8), dtype=torch.bfloat16, device=cuda)
    table = torch.zeros((1, lu.ROW_WORDS), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="2\\^32"):
        lu.langevin_update(x, x, table)
    del x
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32],
                         ids=["f32", "bf16", "i32"])
@pytest.mark.parametrize("depth", [1, 3, 5])
def test_delay_gather_kernel_takes_any_delay_mod_depth(cuda, dtype, depth):
    """Negative and >= depth delays (the int32 extremes too) give
    ``torch.remainder(head - delay, depth)``'s slot, on the vector code
    (n 4096) and the scalar code (n 4099)."""
    for n in (4096, 4099):
        h = _ring_on(cuda, dtype, depth, n, 0, seed=n + depth)
        gen = torch.Generator(device=cuda).manual_seed(depth)
        d = torch.randint(-3 * depth, 3 * depth + 1, (n,), generator=gen,
                          device=cuda, dtype=torch.int32)
        d[:4] = torch.tensor([-2**31, 2**31 - 1, -1, depth], dtype=torch.int32)
        head = depth // 2
        got = dg.delay_gather(h[None], d[None], [head])[0]
        want = ref.delay_gather_ref(h[None], d[None], [head])[0]
        torch.cuda.synchronize()
        assert _bitwise(got, want), n
        slots = torch.remainder(head - d.long(), depth)
        assert torch.equal(got.view(torch.uint8),
                           h.gather(0, slots[None])[0].view(torch.uint8))


# ---------------------------------------------------------------------------
# the chain axis: C chains against each chain alone (C = 1)
# ---------------------------------------------------------------------------
CHAIN_SIZES = [1, 5, 7, 4096, 4099, 65536 + 3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 3, 32])
@pytest.mark.parametrize("offs", [(0, 0), (1, 1), (1, 0), (0, 2)],
                         ids=["aligned", "both-off", "x-off", "g-off"])
def test_langevin_chain_kernel_is_the_single_kernel_chain_by_chain(cuda, dtype, C, offs):
    """Rows of odd sizes start off 16 bytes (the peel, then vectors, then
    the tail); ``offs`` puts x and g that many elements past 16 bytes too,
    and where x and g sit at different offsets (x-off, g-off) every element
    takes the scalar code.  Each chain must equal, bit for bit, the kernel
    on that chain alone (C = 1) in a fresh, aligned allocation (the vector
    code), and the plain version within its float64-emulated fma."""
    xo, go = offs
    for n in CHAIN_SIZES:
        gen = torch.Generator(device=cuda).manual_seed(n * C + 2 * xo + go)
        x = torch.randn(xo + C * n, generator=gen, device=cuda).to(dtype)[xo:].view(C, n)
        g = torch.randn(go + C * n, generator=gen, device=cuda).to(dtype)[go:].view(C, n)
        seeds = rng.split((n, C), C)
        gammas = np.linspace(1e-3, 5e-2, C).astype(np.float32)
        scales = np.linspace(0.0, 0.3, C).astype(np.float32)
        single = [_update_one(x[c].clone(), g[c].clone(), seeds[c], gammas[c], scales[c])
                  for c in range(C)]
        want = ref.langevin_update_ref(x.clone(), g, seeds, gammas, scales)
        before = lu.langevin_update.launches
        got = lu.langevin_update(x, g, _table(lu.chain_rows(seeds, gammas, scales), cuda))
        torch.cuda.synchronize()
        assert got is x and lu.langevin_update.launches == before + 1
        for c in range(C):
            assert _bitwise(got[c], single[c]), (n, c)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
        else:
            assert _within_bf16_ulp(got, want), n


def _chain_ring_on(cuda, dtype, C, depth, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    h = torch.randn(C * depth * n, generator=gen, device=cuda)
    h[:4] = torch.tensor([-0.0, float("inf"), float("nan"), -0.0])[:h.numel()]
    h = (h.nan_to_num(0, 9, -9) * 1000).to(dtype) if dtype == torch.int32 else h.to(dtype)
    return h.view(C, depth, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32],
                         ids=["f32", "bf16", "i32"])
@pytest.mark.parametrize("C", [1, 3, 32])
@pytest.mark.parametrize("depth", [1, 3, 5])
def test_chain_reads_are_the_single_kernels_chain_by_chain(cuda, dtype, C, depth):
    """The one-pass read, gather and draw of C chains against the same
    kernels on each chain alone (C = 1) and the plain versions, bit for
    bit: each chain at its own key and maxval (1, 2, ... depth in turn: the
    zero, low-stream and two-stream draws side by side in one launch) and
    its own ring head (the heads part after masked commits)."""
    for n in (5, 4096, 4099):
        h = _chain_ring_on(cuda, dtype, C, depth, n, seed=n + C + depth)
        heads = [(depth - 1 + 2 * c) % depth for c in range(C)]
        keys = rng.split((n, depth), C)
        maxvals = [1 + c % depth for c in range(C)]
        table = _table(dg.randint_rows(keys, maxvals, heads), cuda)
        counts = (dg.wicon_read.launches, dg.coordinate_delays.launches,
                  dg.delay_gather.launches)
        read = dg.wicon_read(h, table, maxvals, heads)
        delays = dg.coordinate_delays(table, n, maxvals)
        wild = delays * 7 - 9  # any int32: the slot is taken mod depth
        gather = dg.delay_gather(h, wild, heads)
        torch.cuda.synchronize()
        assert (dg.wicon_read.launches, dg.coordinate_delays.launches,
                dg.delay_gather.launches) == tuple(k + 1 for k in counts)
        assert _bitwise(read, ref.wicon_read_ref(h, keys, maxvals, heads))
        assert torch.equal(delays, ref.coordinate_delays_ref(keys, n, maxvals, cuda))
        assert _bitwise(gather, ref.delay_gather_ref(h, wild, heads))
        for c in range(C):
            one = h[c:c + 1].clone()
            t1 = _draw_table(keys[c], maxvals[c], cuda, heads[c])
            assert _bitwise(read[c], dg.wicon_read(one, t1, [maxvals[c]],
                                                   [heads[c]])[0]), (n, c)
            assert torch.equal(delays[c], dg.coordinate_delays(t1, n, [maxvals[c]])[0])
            assert _bitwise(gather[c], dg.delay_gather(one, wild[c:c + 1].clone(),
                                                       [heads[c]])[0])


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4, 32])
def test_chain_ops_launch_once_a_leaf_whatever_c(cuda, C):
    """Three leaves (5 elements, 3 x 7, 64 x 33) of C chains: the fused
    commit and the fused read are 3 launches each, the unfused read 3 draws
    and 3 gathers, and each equals the op on each chain alone (C = 1)."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    shapes = {"a": (5,), "b": (3, 7), "c": (64, 33)}
    params = {k: torch.randn(C, *s, generator=gen, device=cuda) for k, s in shapes.items()}
    grads = {k: torch.randn(C, *s, generator=gen, device=cuda) for k, s in shapes.items()}
    seeds = rng.split((C, 1), C)
    gammas = [np.float32(1e-2)] * C
    scales = [np.float32(0.05)] * C
    want = [ops.fused_langevin_update({k: v[c:c + 1].clone() for k, v in params.items()},
                                      {k: v[c:c + 1].clone() for k, v in grads.items()},
                                      [seeds[c]], [gammas[c]], [scales[c]])
            for c in range(C)]
    before = lu.langevin_update.launches
    ops.fused_langevin_update(params, grads, seeds, gammas, scales)
    assert lu.langevin_update.launches == before + 3
    for c in range(C):
        for k in shapes:
            assert _bitwise(params[k][c], want[c][k][0])
    ring = tdelay.RingBuffer({k: torch.randn(C, 3, *s, generator=gen, device=cuda)
                              for k, s in shapes.items()},
                             head=torch.tensor([(2 + c) % 3 for c in range(C)]), depth=3)
    keys, delays = rng.split((9, C), C), [c % 4 for c in range(C)]
    for fused, counters in ((True, (dg.wicon_read,)),
                            (False, (dg.coordinate_delays, dg.delay_gather))):
        before = [k.launches for k in counters]
        got = tdelay.read_inconsistent_leafwise(ring, keys, delays, fused=fused)
        assert [k.launches for k in counters] == [b + 3 for b in before]
        for c in range(C):
            one = tdelay.RingBuffer({k: v[c:c + 1].clone() for k, v in ring.history.items()},
                                    ring.head[c:c + 1], 3)
            single = tdelay.read_inconsistent_leafwise(one, [keys[c]], [delays[c]],
                                                       fused=fused)
            for k in shapes:
                assert _bitwise(got[k][c], single[k][0]), (fused, c, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 4, 32])
def test_langevin_kernel_skips_rows_and_flags_nonfinite_chains(cuda, dtype, C):
    """A skipped chain's row is bitwise untouched, a NaN gradient row
    included; kept rows are bitwise the unmasked kernel; the non-finite
    flags equal ``torch.isfinite`` of the kept rows and the plain
    version's flags, on the vector code (4096), the peel and tail (4099)
    and a row of 5."""
    for n in (5, 4096, 4099):
        gen = torch.Generator(device=cuda).manual_seed(n + C)
        x = torch.randn(C, n, generator=gen, device=cuda).to(dtype)
        g = torch.randn(C, n, generator=gen, device=cuda).to(dtype)
        skip = np.array([c % 3 == 1 for c in range(C)])
        g[torch.from_numpy(skip).to(cuda)] = float("nan")  # never read
        bad = [c for c in range(C) if c % 4 == 2]
        for c in bad:
            g[c, n // 2] = float("inf")
        seeds = rng.split((n, C), C)
        gammas = np.full(C, 1e-2, np.float32)
        scales = np.linspace(0.0, 0.3, C).astype(np.float32)
        plain = lu.langevin_update(x.clone(), g, _table(lu.chain_rows(seeds, gammas, scales),
                                                        cuda))
        want_flags = torch.zeros(C, dtype=torch.int32)
        want = ref.langevin_update_ref(x.clone(), g, seeds, gammas, scales, skip, want_flags)
        flags = torch.zeros(C, dtype=torch.int32, device=cuda)
        got = lu.langevin_update(x.clone(), g, _table(lu.chain_rows(
            seeds, gammas, scales, skip), cuda), flags)
        torch.cuda.synchronize()
        for c in range(C):
            assert _bitwise(got[c], x[c] if skip[c] else plain[c]), (n, c)
        expect = (~torch.isfinite(got).all(dim=1)).cpu() & ~torch.from_numpy(skip)
        assert flags.cpu().tolist() == expect.to(torch.int32).tolist() \
            == want_flags.tolist() == [int(c in bad and not skip[c]) for c in range(C)]
        if dtype == torch.float32:
            torch.testing.assert_close(got.cpu(), want.cpu(), rtol=0, atol=2e-6,
                                       equal_nan=True)


@pytest.mark.cuda
def test_masked_commit_on_card_equals_the_cpu(cuda):
    """The ClusterEngine under a chaos schedule, a poison and
    ``health_check`` (fused W-Icon: kernel skips, flags, the ring restore)
    gives the CPU run's health masks, heads and keys, and iterates within
    1e-5 + 1e-4 x |CPU|."""
    from repro_torch import samplers
    from repro_torch.cluster import ClusterEngine, ensemble_async
    from repro_torch.core import FaultPlan, Quadratic, WorkerModel

    C = 8
    scheds = ensemble_async(WorkerModel(num_workers=4, seed=1, faults=FaultPlan(
        crash_rate=0.15, mean_downtime=2.0)), 40, C, seed=0)
    poison = np.zeros((40, C), bool)
    poison[5, 2] = poison[17, 6] = True
    out = {}
    for dev in ("cpu", cuda):
        q = Quadratic.make(rng.PRNGKey(0), d=4, m=1.0, L=3.0, device=dev)
        s = samplers.sgld("inconsistent", lambda p, b, q=q: q.grad(p, b), gamma=0.01,
                          sigma=0.5, tau=32, fused=True)
        e = ClusterEngine(s, num_chains=C, chunk_size=10, health_check=True,
                          respawn=False)
        st, _ = e.run(e.init(torch.zeros(4, device=dev), rng.PRNGKey(3)), steps=40,
                      schedule=scheds, poison=poison)
        out[str(dev)] = st
    a, b = out["cpu"], out[str(cuda)]
    assert np.array_equal(a.health, b.health) and not a.health[2] and not a.health[6]
    assert a.key == b.key and torch.equal(a.inner[0].head, b.inner[0].head)
    torch.testing.assert_close(b.params.cpu(), a.params, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_table_copies_do_not_stall_the_host(cuda):
    """The per-commit tables reach the card by a copy from pinned memory on
    the current stream: a commit enqueued behind a long kernel returns to
    the host before that kernel ends, and the result is the same as after a
    synchronise."""
    a = torch.randn(4096, 4096, device=cuda)
    x = torch.randn(2, 1_000_003, device=cuda)
    g = torch.randn_like(x)
    want = x.clone()
    ops.fused_langevin_update({"x": want}, {"x": g}, [(1, 2), (3, 4)],
                              [np.float32(1e-2)] * 2, [np.float32(0.1)] * 2)
    torch.cuda.synchronize()
    busy = a
    for _ in range(20):  # ~tens of ms of matmuls on the stream
        busy = busy @ a
    done = torch.cuda.Event()
    done.record()
    ops.fused_langevin_update({"x": x}, {"x": g}, [(1, 2), (3, 4)],
                              [np.float32(1e-2)] * 2, [np.float32(0.1)] * 2)
    assert not done.query()  # the host did not wait for the matmuls
    torch.cuda.synchronize()
    assert _bitwise(x, want)


@pytest.mark.cuda
def test_transfer_guard_turns_a_host_sync_into_an_error(cuda):
    """``instrument(transfer_guard="error")`` sets the sync debug mode for
    its region, nested regions included, and restores it on exit; a host
    read of a card tensor inside raises, one outside does not; ``"warn"``
    records it."""
    from repro_torch.analysis import instrument

    x = torch.arange(4.0, device=cuda)
    before = torch.cuda.get_sync_debug_mode()
    with pytest.raises(RuntimeError):
        with instrument(transfer_guard="error"):
            x[1].item()
    assert torch.cuda.get_sync_debug_mode() == before
    with instrument(transfer_guard="error"):
        with instrument(transfer_guard="warn") as inner:
            x.sum().item()  # the inner mode: warned, not raised
        assert torch.cuda.get_sync_debug_mode() == 2
        y = x * 2  # no host read: passes
    assert torch.cuda.get_sync_debug_mode() == before
    assert len(inner.sync_warnings) >= 1
    assert y.cpu().tolist() == [0.0, 2.0, 4.0, 6.0]


@pytest.mark.cuda
def test_prefetcher_copies_on_a_side_stream(cuda):
    """On the card the prefetched batches are the CPU batches, key for key,
    copied from pinned memory on a side stream the consumer waits on."""
    from repro_torch.data import Prefetcher
    from repro_torch.kernels import rng

    def batch_fn(key):
        return {"u": rng.jax_uniform(key, (256, 64), device="cpu"),
                "k": np.asarray(key, np.uint32)}

    pf = Prefetcher(batch_fn, rng.PRNGKey(5), device=cuda, depth=2)
    cpu = Prefetcher(batch_fn, rng.PRNGKey(5), device="cpu", depth=2)
    try:
        for _ in range(5):
            got, want = next(pf), next(cpu)
            assert got["u"].device.type == "cuda"
            busy = torch.randn(2048, 2048, device=cuda)
            (busy @ busy).sum()  # the consumer stream has work of its own
            assert torch.equal(got["u"].cpu(), want["u"])
            assert torch.equal(got["k"].cpu(), want["k"])
    finally:
        pf.close()
        cpu.close()
    assert pf._stream is not None and pf._stream != torch.cuda.current_stream(cuda)
