"""repro_torch.data.pipeline.Prefetcher against repro.data.pipeline's (the
twin of ``tests/test_pipeline.py``): the batches are the reference's, key
for key — the port's ``rng.split`` is ``jax.random.split`` bit for bit, and
a batch drawn with ``rng.jax_uniform`` under a key is the reference's
``jax.random.uniform`` under it.  On the CPU the batches come back as
tensors; the side-stream copy to a card is held by the ``cuda`` test in
``tests/test_torch_kernels_cuda.py``."""

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import Prefetcher as JaxPrefetcher
from repro_torch.data import Prefetcher
from repro_torch.kernels import rng


def test_prefetcher_yields_distinct_batches():
    pf = Prefetcher(lambda key: {"x": rng.jax_normal(key, (4, 8), "cpu")},
                    rng.PRNGKey(0), device="cpu")
    try:
        b1, b2 = next(pf), next(pf)
        assert b1["x"].shape == (4, 8)
        assert float((b1["x"] - b2["x"]).abs().max()) > 0
    finally:
        pf.close()


def test_prefetcher_keeps_up():
    pf = Prefetcher(lambda key: rng.randint(key, 16, 100), rng.PRNGKey(1),
                    device="cpu", depth=3)
    try:
        out = [next(pf) for _ in range(10)]
        assert len(out) == 10 and all(torch.is_tensor(b) for b in out)
    finally:
        pf.close()


@pytest.mark.parametrize("seed,depth", [(0, 2), (7, 1), (123, 4)])
def test_batches_equal_the_references_key_for_key(seed, depth):
    def port_fn(key):
        return {"key": np.asarray(key, np.uint32),
                "u": rng.jax_uniform(key, (5,), device="cpu")}

    def ref_fn(key):
        return {"key": jax.random.key_data(key), "u": jax.random.uniform(key, (5,))}

    pf = Prefetcher(port_fn, rng.PRNGKey(seed), device="cpu", depth=depth)
    jpf = JaxPrefetcher(ref_fn, jax.random.PRNGKey(seed), depth=depth)
    try:
        for _ in range(6):
            got, want = next(pf), next(jpf)
            np.testing.assert_array_equal(got["key"].numpy(), np.asarray(want["key"]))
            np.testing.assert_array_equal(got["u"].numpy(), np.asarray(want["u"]))
    finally:
        pf.close()
        jpf.close()


def test_close_joins_the_thread():
    pf = Prefetcher(lambda key: torch.zeros(2), rng.PRNGKey(0), device="cpu")
    next(pf)
    pf.close()
    assert not pf.thread.is_alive()


def test_a_failing_batch_fn_raises_from_next():
    def bad(key):
        raise RuntimeError("no data")

    pf = Prefetcher(bad, rng.PRNGKey(0), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="no data"):
            next(pf)
    finally:
        pf.close()


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Prefetcher(lambda key: torch.zeros(1), rng.PRNGKey(0))
