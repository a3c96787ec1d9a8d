"""The split plan of the split-KV decode kernels, on the CPU.

``kernels/decode_step.py`` hands the CUDA kernels a plan computed in
Python from the shapes alone: how many splits each (row or slot, KV head)
gets and which positions each split attends over.  These tests pin the
plan (chunks tile the positions with no gap and no overlap, paged chunks
are whole pages within the bounds the launcher checks, the plan depends on
the shapes only, a block's shared memory stays under the card's 232,448
bytes up to 32,768 positions).  The kernels themselves are held against
the plain steps on a card (``test_torch_kernels_cuda.py``).  Imports no
JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_step as ds

SMAXES = [1, 7, 8, 31, 32, 33, 48, 255, 256, 257, 1000, 1024, 4096, 16384,
          32768]
PAGED_SHAPES = [(1, 8), (4, 4), (8, 4), (16, 16), (16, 256), (3, 20),
                (16, 2048)]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smax", SMAXES)
def test_ring_chunks_tile_the_ring(smax):
    splits, chunk = ds.ring_plan(smax)
    assert 1 <= splits <= ds.MAX_SPLITS
    assert chunk % ds.TILE == 0
    covered = np.zeros(smax, int)
    for j in range(splits):
        t0, t1 = j * chunk, min((j + 1) * chunk, smax)
        assert t0 < t1  # no split is planned empty
        covered[t0:t1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("smax,want", [(256, (4, 64)), (1024, (16, 64)),
                                       (16384, (16, 1024)), (32768, (16, 2048))])
def test_ring_plan_at_the_main_path_shapes(smax, want):
    """Up to 16 splits a (row, head) of at least two tiles: 16 rows x 8 KV
    heads of a 1024-slot ring make 2,048 blocks."""
    assert ds.ring_plan(smax) == want


@pytest.mark.parametrize("ps,maxp", PAGED_SHAPES)
def test_paged_chunks_are_whole_pages_tiling_each_slot(ps, maxp):
    splits = ds.paged_plan(maxp)
    assert 1 <= splits <= ds.MAX_SPLITS
    max_pages = ds.paged_max_pages(maxp, ps)
    rng = np.random.default_rng(ps * 1000 + maxp)
    cand = {0, ps - 1, ps, maxp * ps - 1, *rng.integers(0, maxp * ps, 40)}
    for pos in sorted(int(p) for p in cand if p < maxp * ps):
        covered = np.zeros(pos + 1, int)
        for j in range(splits):
            t0, t1 = ds.paged_chunk(pos, ps, splits, j)
            assert t0 <= t1 and t0 % ps == 0
            if t1 > t0:
                assert t1 == pos + 1 or t1 % ps == 0  # whole pages, the last to pos
                assert -(-(t1 - t0) // ps) <= max_pages
            covered[t0:t1] += 1
        assert (covered == 1).all(), (pos, covered)


@pytest.mark.parametrize("ps,maxp", PAGED_SHAPES)
def test_paged_plan_passes_the_launchers_check(ps, maxp):
    """The launcher refuses a plan whose page ids could overflow a block's
    shared memory: a split takes max(ceil(used / splits), min_pages) pages
    of the slot's ``used <= maxp``, so max_pages must hold min(maxp,
    min_pages) and splits * max_pages must reach maxp."""
    splits = ds.paged_plan(maxp)
    lo, hi = ds.paged_min_pages(ps), ds.paged_max_pages(maxp, ps)
    assert lo >= 1 and lo * ps >= ds.MIN_CHUNK
    assert hi >= min(maxp, lo) and hi * splits >= maxp
    for used in range(1, maxp + 1):
        per = max(-(-used // splits), lo)
        assert max(min(per, used - j * per) for j in range(splits)) <= hi


def test_paged_plan_spreads_a_long_slot_over_the_splits():
    """The paged cell's slot at position 255 (16 pages of 16): 4 splits of
    4 pages (64 positions, the least a split takes); the slot at position 7
    keeps split 0 only; a 4,096-position window's last slot: all 16 splits,
    16 pages each."""
    splits = ds.paged_plan(16)
    assert splits == 16
    chunks = [ds.paged_chunk(255, 16, splits, j) for j in range(splits)]
    assert chunks[:5] == [(0, 64), (64, 128), (128, 192), (192, 256), (256, 256)]
    assert ds.paged_chunk(7, 16, splits, 0) == (0, 8)
    assert all(ds.paged_chunk(7, 16, splits, j)[0] == ds.paged_chunk(7, 16, splits, j)[1]
               for j in range(1, splits))
    assert [ds.paged_chunk(4095, 16, 16, j) for j in (0, 15)] == [(0, 256),
                                                                 (3840, 4096)]


@pytest.mark.parametrize("smax", SMAXES)
def test_plan_depends_on_the_shapes_only(smax):
    """Equal shapes give equal plans whatever else differs (the kernel's
    result is then the same bits on every call)."""
    assert ds.ring_plan(smax) == ds.ring_plan(int(np.int64(smax)))
    maxp = max(1, smax // 16)
    assert ds.paged_plan(maxp) == ds.paged_plan(maxp)
    plans = {ds.ring_plan(smax) for _ in range(3)}
    assert len(plans) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 112, 128, 160])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 7, 8])
def test_shared_memory_fits_up_to_32768_positions(dtype, hd, G):
    """A block's shared memory does not grow with the ring; the paged
    chunk's page ids grow with maxp / splits, even at page size 1."""
    elem = 4 if dtype == "float32" else 2
    ring = ds.smem_bytes(G, hd, elem)
    for ps in (1, 16):
        maxp = 32768 // ps
        paged = ds.smem_bytes(G, hd, elem, ds.paged_max_pages(maxp, ps))
        assert paged <= ds._SMEM_LIMIT
    assert ring <= ds._SMEM_LIMIT
    assert ds.smem_bytes(G, hd, elem) == ring  # nothing depends on smax


def test_plan_rejects_empty_shapes():
    with pytest.raises(ValueError):
        ds.ring_plan(0)
    with pytest.raises(ValueError):
        ds.paged_plan(0)


def test_decode_wrapper_takes_a_16384_slot_ring_past_its_checks():
    """The old kernel kept every score in shared memory and refused rings
    above 13,504 slots; the split kernel's checks pass a 16,384-slot ring
    and stop only at the device (this container has no card)."""
    N, KV, G, hd, smax = 1, 1, 4, 128, 16384
    q = torch.zeros(N, KV, G, hd)
    kn = torch.zeros(N, KV, hd)
    kc = torch.zeros(N, smax, KV, hd)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        ds.decode_step(q, kn, kn.clone(), kc, kc.clone(),
                       torch.ones(smax, dtype=torch.int32), 3)


@pytest.mark.parametrize("G,compiled", [(3, True), (5, True), (6, False), (7, True)])
def test_decode_wrappers_take_the_compiled_groups(G, compiled):
    """Groups 3 (12 query heads over 4 KV heads), 5 (hymba-1.5b's 25 over
    5) and 7 (internvl2-1b's 14 over 2) pass both wrappers' checks and stop
    only at the device; group 6 (no config has it) is refused as not
    compiled."""
    KV, hd, smax = 4, 64, 32
    q = torch.zeros(2, KV, G, hd)
    kn = torch.zeros(2, KV, hd)
    kc = torch.zeros(2, smax, KV, hd)
    ring = lambda: ds.decode_step(q, kn, kn.clone(), kc, kc.clone(),  # noqa: E731
                                  torch.ones(smax, dtype=torch.int32), 3)
    pages = torch.zeros(1, 9, 4, KV, hd)
    paged = lambda: ds.paged_decode_step(  # noqa: E731
        q[None], kn[None], kn[None].clone(), pages, pages.clone(),
        torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    for call in (ring, paged):
        with pytest.raises(ValueError, match="launches a CUDA kernel" if compiled
                           else "not compiled"):
            call()


@pytest.mark.parametrize("hd,compiled", [(112, True), (160, True), (96, False)])
def test_decode_wrappers_take_the_compiled_head_dims(hd, compiled):
    """head_dim 112 (kimi-k2, G 8) and 160 (stablelm-12b, G 4) pass both
    wrappers' checks and stop only at the device; 96 is refused as not
    compiled, with no plain fallback."""
    KV, G, smax = 2, 8 if hd == 112 else 4, 32
    q = torch.zeros(2, KV, G, hd)
    kn = torch.zeros(2, KV, hd)
    kc = torch.zeros(2, smax, KV, hd)
    pages = torch.zeros(1, 9, 4, KV, hd)
    calls = (lambda: ds.decode_step(q, kn, kn.clone(), kc, kc.clone(),
                                    torch.ones(smax, dtype=torch.int32), 3),
             lambda: ds.paged_decode_step(
                 q[None], kn[None], kn[None].clone(), pages, pages.clone(),
                 torch.zeros(2, 4, dtype=torch.int32),
                 torch.zeros(2, dtype=torch.int32)))
    for call in calls:
        with pytest.raises(ValueError, match="launches a CUDA kernel" if compiled
                           else "not compiled"):
            call()


@pytest.mark.parametrize("G,hd", [(8, 112), (4, 160), (7, 64)])
def test_new_shapes_fit_shared_memory_and_its_row_groups(G, hd):
    """The new shapes' blocks fit the card's shared memory in both dtypes,
    and the reduction region holds the whole row groups of p . V: floor(128
    / segs) groups, segs the 16-byte copies of a row (28 or 40 in f32 at
    head_dim 112 or 160, which do not divide the block's 128 threads)."""
    for elem in (2, 4):
        segs = hd * elem // 16
        groups = ds.THREADS // segs
        assert groups * segs <= ds.THREADS and groups >= 1
        tiles = ds.STAGES * 2 * ds.TILE * (hd * elem + 16)
        head = ds.smem_bytes(G, hd, elem) - max(tiles, groups * G * hd * 4)
        assert head > 0
        assert ds.smem_bytes(G, hd, elem, 256) <= ds._SMEM_LIMIT
