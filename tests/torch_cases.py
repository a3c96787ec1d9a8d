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


def in_place_case(kernel: str, device, on_card: bool):
    """Inputs of one in-place kernel at a small bf16 size, and a launch:
    ``(written, launch)`` — ``written`` the tensors it writes in place
    ({name: tensor}), ``launch()`` one call of the CUDA wrapper
    (``on_card``) or of its plain version (the same arguments)."""
    from repro_torch.kernels import decode_step as ds
    from repro_torch.kernels import langevin_update as lu
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(13)
    r = lambda *s: torch.randn(*s, generator=gen).to(device, torch.bfloat16)  # noqa: E731
    if kernel == "langevin_update":
        C, n = 3, 1000
        x, g = r(C, n), r(C, n)
        g[1, 7] = float("nan")  # chain 1 goes non-finite: both versions write flags
        flags = torch.zeros(C, dtype=torch.int32, device=device)
        seeds, gammas, scales = [(7, c) for c in range(C)], [1e-3] * C, [0.03] * C
        table = torch.from_numpy(lu.chain_rows(seeds, gammas, scales).view(np.int32))
        if on_card:
            table = table.to(device)
            return {"x": x, "flags": flags}, lambda: lu.langevin_update(x, g, table, flags)
        return {"x": x, "flags": flags}, lambda: ref.langevin_update_ref(
            x, g, seeds, gammas, scales, flags=flags)
    if kernel == "decode_step":
        N, smax, slot = 3, 32, 5
        q, kn, vn = r(N, KV, G, HD), r(N, KV, HD), r(N, KV, HD)
        kc, vc = r(N, smax, KV, HD), r(N, smax, KV, HD)
        valid = torch.ones(smax, dtype=torch.int32, device=device)
        step = ds.decode_step if on_card else ref.decode_step_ref
        return ({"k_cache": kc, "v_cache": vc},
                lambda: step(q, kn, vn, kc, vc, valid, slot))
    c = paged_case(13, 2)
    t = {k: torch.from_numpy(v).to(device) for k, v in c.items()}
    for k in ("q", "k_new", "v_new", "k_pages", "v_pages"):
        t[k] = t[k].to(torch.bfloat16)
    C, S = t["q"].shape[:2]
    q = t["q"].reshape(C, S, KV, G, HD)
    step = ds.paged_decode_step if on_card else ref.paged_decode_step_ref
    return ({"k_pages": t["k_pages"], "v_pages": t["v_pages"]},
            lambda: step(q, t["k_new"], t["v_new"], t["k_pages"], t["v_pages"],
                         t["tables"], t["pos"]))
