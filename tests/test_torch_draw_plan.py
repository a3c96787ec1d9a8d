"""The launch plans of the two draw kernels, on the CPU (no card, no JAX):
shape-only Python mirrors of ``csrc/jax_draw.cu``'s and
``csrc/categorical.cu``'s index arithmetic.

- ``jax_draw``: every element of a block is written once, at its counter in
  the whole draw (``rng._flat_counters``), for whole draws, blocks of 1 to 6
  merged dimensions, ragged lengths, counters straddling 2^32, and 1 to
  65,535 rows; the 32-bit path's divisions by magic numbers equal integer
  division.
- ``categorical``: every column of a row is read once, at every alignment
  of the row's start, for V that 8 does or does not divide, and 1 to 65,535
  rows; the vectors start on 16-byte boundaries.
- The combine's ordered 64-bit keys pick ``torch.argmax``'s index: random
  rows, ties, NaN, +-inf, -0.0 and a row of -inf.

The card's tests (``tests/test_torch_kernels_cuda.py``) hold the kernels
themselves to their plain versions bit for bit.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import categorical as kc
from repro_torch.kernels import jax_draw as jd
from repro_torch.kernels import rng

WAVE = 132 * 4  # blocks an H100 holds at once at four a multiprocessor


def _covered(shape, block, start: int, rows: int = 1):
    """Each element's (row offset, counter) as the kernel writes it, over
    the launch's grid: asserts every group is visited once."""
    parts = rng._block_of(shape, block)
    p = jd.plan(jd.geometry(shape, parts, start))
    bx, by = jd.grid(p, rows, WAVE)
    assert by == rows and 1 <= bx * jd.THREADS
    # the grid-stride loop: block x, thread t, pass k take group
    # x * THREADS + t + k * bx * THREADS
    passes = -(-p["groups"] // (bx * jd.THREADS))
    g = (np.arange(passes)[:, None, None] * bx * jd.THREADS
         + np.arange(bx)[None, :, None] * jd.THREADS + np.arange(jd.THREADS)[None, None, :])
    g = np.sort(g[g < p["groups"]])
    np.testing.assert_array_equal(g, np.arange(p["groups"]))
    first, counter, length = jd.group_elements(p, g)
    assert (length >= 1).all() and (length <= jd.PER).all()
    offs = np.concatenate([first + i for i in range(jd.PER)])
    cnts = np.concatenate([counter + i for i in range(jd.PER)])
    keep = np.concatenate([i < length for i in range(jd.PER)])
    return p, parts, offs[keep], cnts[keep]


def _check_block(shape, block, start: int = 0):
    p, parts, offs, cnts = _covered(shape, block, start)
    n = math.prod(length for _, length in parts)
    assert p["n"] == n
    order = np.argsort(offs)
    np.testing.assert_array_equal(offs[order], np.arange(n))  # each element once
    want = rng._flat_counters(tuple(shape), parts, start, 0, n, "cpu").numpy()
    np.testing.assert_array_equal(cnts[order], want)
    assert p["wide"] == (int(want.max()) >= 2**32)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 2047, 2048, 2049, 100_003])
def test_draw_plan_covers_a_whole_draw(n):
    _check_block((n,), None)


BLOCKS = [
    # (shape, block): 1 .. 6 dimensions after merging (leading rows merge into
    # one), ragged lines
    ((1, 4, 256, 97), (slice(None), slice(None), slice(None), slice(48, 97))),
    ((3, 5, 7, 64), (slice(None), slice(None), slice(None), slice(10, 41))),
    ((3, 5, 7, 64), (slice(1, 3), slice(None), slice(None), slice(None))),
    ((3, 5, 7, 64), (slice(None), slice(2, 4), slice(1, 6), slice(None))),
    ((4, 6, 5, 9), (slice(1, 4), slice(0, 5), slice(1, 4), slice(2, 9))),
    ((3, 4, 3, 4, 5), (slice(0, 2), slice(1, 3), slice(0, 2), slice(1, 4), slice(0, 3))),
    ((2, 3, 2, 3, 2, 13), (slice(0, 1), slice(1, 3), slice(0, 1), slice(1, 2), slice(1, 2),
                           slice(3, 12))),
    ((2, 3, 2, 3, 2, 3, 11), (slice(None), slice(1, 3), slice(0, 1), slice(1, 3), slice(0, 1),
                              slice(None), slice(2, 10))),
]


@pytest.mark.parametrize("shape, block", BLOCKS, ids=[f"{len(s)}d-{i}"
                                                       for i, (s, _) in enumerate(BLOCKS)])
def test_draw_plan_covers_a_block(shape, block):
    _check_block(shape, block, start=5)


def test_the_blocks_merge_to_every_depth():
    dims = {jd.geometry(s, rng._block_of(s, b), 0)[0] for s, b in BLOCKS}
    assert dims == set(range(1, jd.MAX_DIMS + 1))


@pytest.mark.parametrize("start", [2**32 - 4000, 2**32 - 1, 2**32, 2**33 + 5])
def test_draw_plan_straddles_2_32(start):
    _check_block((9000,), None, start)
    _check_block((3, 5, 700), (slice(None), slice(1, 4), slice(3, 650)), start)


@pytest.mark.parametrize("rows", [1, 2, 36, 528, 529, 65_535])
def test_draw_plan_rows(rows):
    """A key a row: row r at offset r n; every row's groups once over the
    grid (the grid's x shrinks as the rows grow, each block loops)."""
    n = 3 if rows > 1000 else 1001
    p = jd.plan(jd.geometry((n,), [(0, n)], 0))
    bx, by = jd.grid(p, rows, WAVE)
    assert by == rows and bx == min(-(-p["groups"] // jd.THREADS), -(-WAVE // rows))
    first, counter, length = jd.group_elements(p, np.arange(p["groups"]))
    row = np.concatenate([first + i for i in range(jd.PER)])[
        np.concatenate([i < length for i in range(jd.PER)])]
    flat = (np.arange(rows)[:, None] * p["n"] + np.sort(row)[None]).ravel()
    np.testing.assert_array_equal(flat, np.arange(rows * n))
    np.testing.assert_array_equal(counter, first)  # counters [0, n)


@pytest.mark.parametrize("rows", [0, 65_536])
def test_draw_plan_refuses_rows_past_the_grid(rows):
    p = jd.plan(jd.geometry((10,), [(0, 10)], 0))
    with pytest.raises(ValueError, match="rows"):
        jd.grid(p, rows, WAVE)


def test_the_draw_kernels_division_by_magic_numbers():
    gen = np.random.default_rng(0)
    ds = [1, 2, 3, 7, 608, 4864, 9728, 2**30 + 1, 2**31 - 1] + list(gen.integers(1, 2**31, 50))
    for d in ds:
        n = np.concatenate([[0, 1, d - 1, d, d + 1, 2**31 - 1],
                            gen.integers(0, 2**31, 200)]).astype(np.int64)
        m, shift = jd.magic(int(d))
        assert 0 <= m < 2**32
        np.testing.assert_array_equal(jd._div(n, int(d), False), n // d)


def test_vectors_need_aligned_rows_and_lines():
    whole = jd.plan(jd.geometry((1001,), [(0, 1001)], 0))
    block = jd.plan(jd.geometry((4, 100), [(0, 4), (3, 97)], 0))
    aligned = jd.plan(jd.geometry((4, 100), [(0, 4), (4, 96)], 0))
    assert jd.vector_ok(256, 1, whole) and not jd.vector_ok(258, 1, whole)
    assert not jd.vector_ok(256, 2, whole)  # row 1 starts at element 1001
    assert not jd.vector_ok(256, 1, block) and jd.vector_ok(256, 1, aligned)


# ---------------------------------------------------------------------------
# categorical
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("V", [1, 5, 7, 8, 9, 1023, 1024, 1025, 32_003, 151_935, 151_936])
@pytest.mark.parametrize("elsize", [2, 4], ids=["16-bit", "f32"])
def test_categorical_plan_covers_every_column(V, elsize):
    bx, by = kc.plan(4, V)
    assert by == 4
    for shift in range(16 // elsize):  # the row's start, shift elements past 16 bytes
        ptr = 4096 + shift * elsize
        peel = kc.peel_of(ptr, elsize, V)
        assert peel == min((-shift) % (16 // elsize), V)
        cols, vec_starts = [], []
        for s, t in itertools.product(range(bx), range(kc.THREADS)):
            mine = kc.thread_columns(V, peel, s, t)
            cols += mine
            v0 = peel + (s * kc.THREADS + t) * kc.COLS
            if v0 + kc.COLS <= V:
                vec_starts.append(v0)
        assert sorted(cols) == list(range(V))  # every column once
        assert all((ptr + v * elsize) % 16 == 0 for v in vec_starts)


def test_categorical_plan_fills_the_card():
    """(4, 151,936): 596 blocks of 128 threads, one wave on 132 SMs."""
    bx, by = kc.plan(4, 151_936)
    assert (bx, by) == (149, 4) and bx * by * kc.THREADS <= 132 * 2048


@pytest.mark.parametrize("rows", [0, 65_536])
def test_categorical_plan_refuses_rows_past_the_grid(rows):
    with pytest.raises(ValueError, match="rows"):
        kc.plan(rows, 10)


def test_categorical_plan_takes_up_to_65535_rows():
    assert kc.plan(65_535, 3) == (1, 65_535)


def _edge_rows():
    nan, inf = float("nan"), float("inf")
    rows = [
        [1.0, nan, 2.0, nan],          # the first NaN
        [-inf, -inf, -inf, -inf],      # index 0
        [-0.0, 0.0, -0.0, -1.0],       # -0.0 equals 0.0: the first
        [0.0, -0.0, 0.0, -1.0],
        [inf, 3.0, inf, nan],          # NaN above +inf
        [-inf, inf, -inf, inf],        # a tie of +inf
        [-1.0, -1.0, -2.0, -inf],      # a tie
        [-3e38, -inf, -1e-45, -2e-45],  # denormals, the least normal
        [1e-45, 0.0, -0.0, 1e-45],
    ]
    return torch.tensor(rows, dtype=torch.float32)


def test_ordered_keys_pick_argmax_on_the_edge_rows():
    x = _edge_rows()
    np.testing.assert_array_equal(kc.argmax_of_keys(kc.ordered_keys(x)), torch.argmax(x, -1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_ordered_keys_pick_argmax_on_random_rows(dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64, 1000, generator=g).to(dtype)  # bf16 / f16 rows hold ties
    x[3, 10] = x[3, 500] = x[3].max() + 1
    x[5, 7] = float("nan")
    x[6] = float("-inf")
    x[7, ::3] = float("inf")
    x[8, 100:] = -0.0
    x[8, :100] = float("-inf")
    gumbel = rng.gumbel(rng.PRNGKey(2), x.shape)
    v = x.float() + gumbel  # the kernel's candidates
    np.testing.assert_array_equal(kc.argmax_of_keys(kc.ordered_keys(v)), torch.argmax(v, -1))
    np.testing.assert_array_equal(kc.argmax_of_keys(kc.ordered_keys(x.float())),
                                  torch.argmax(x.float(), -1))
