"""Inputs shared by the port's kernel tests: ring-cache and paged decode
steps made from a numpy seed, and the pool comparison that allows for the
garbage row; and a fixture for the CPU parity tests.  Imports no JAX, so
the card-only tests run where JAX is not installed."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """Run a module's tests on one ATen thread.  The suite runs in several
    worker processes at once; ATen's OpenMP threads, spinning against each
    other's, slow the parity tests' many small CPU ops by 10x or more.
    A test module takes it with ``from torch_cases import one_cpu_thread``."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

KV, G, HD = 2, 2, 64
RING_CASES = [
    dict(seed=0, N=3, smax=16, slot=5, n_valid=9),
    dict(seed=1, N=2, smax=32, slot=31, n_valid=32),
    dict(seed=2, N=4, smax=8, slot=0, n_valid=0),
]
RING_IDS = ["partial", "full", "only-slot"]


def ring_case(seed, N, smax, slot, n_valid, *, kv=KV, g=G, hd=HD):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    valid = np.zeros((smax,), np.int32)
    valid[rng.permutation(smax)[:n_valid]] = 1
    valid[slot] = 1
    return dict(q=f(N, kv * g, hd), k_new=f(N, kv, hd), v_new=f(N, kv, hd),
                k_cache=f(N, smax, kv, hd), v_cache=f(N, smax, kv, hd),
                valid=valid, slot=slot)


def paged_case(seed, C, *, n_pages=12, ps=4, maxp=4, kv=KV, g=G, hd=HD):
    """Five slots: three active on a permuted page table (one ending on a
    page boundary), two inactive on the garbage page (table row 0, pos 0)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    S = 5
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((S, maxp), np.int32)
    tables[0, :3] = perm[0:3]
    tables[1, :2] = perm[3:5]
    tables[2, :4] = perm[5:9]
    pos = np.array([9, 4, maxp * ps - 1, 0, 0], np.int32)
    return dict(q=f(C, S, kv * g, hd), k_new=f(C, S, kv, hd),
                v_new=f(C, S, kv, hd), k_pages=f(C, n_pages, ps, kv, hd),
                v_pages=f(C, n_pages, ps, kv, hd), tables=tables, pos=pos)


def garbage_writers(tables, pos, ps):
    rows = tables[np.arange(len(pos)), pos // ps] * ps + pos % ps
    vals, counts = np.unique(rows, return_counts=True)
    return set(vals[counts > 1].tolist())


def assert_pool_equal(got, want, shared_rows, new_rows, ps):
    """Pools equal bit-for-bit, except a row that several slots wrote this
    step (the garbage row): the slots race on it element by element, so
    each element there is that element of one of the rows written."""
    C = got.shape[0]
    gf = got.reshape(C, -1, *got.shape[3:])
    wf = want.reshape(C, -1, *want.shape[3:])
    keep = np.ones(gf.shape[1], bool)
    keep[list(shared_rows)] = False
    np.testing.assert_array_equal(gf[:, keep], wf[:, keep])
    for r, slots in shared_rows.items():
        cands = new_rows[:, slots]  # (C, writers, KV, hd)
        assert (cands == gf[:, r][:, None]).any(axis=1).all()
