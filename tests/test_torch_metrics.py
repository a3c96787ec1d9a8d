"""repro_torch.metrics against repro.metrics on the same point clouds, on
the CPU.  Both run in float32; the eigendecompositions, inverses and
reductions are LAPACK's and ATen's on one side and XLA's on the other, so
the estimators agree within the relative tolerance each test states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import metrics as jm
from repro_torch import metrics as tm
from torch_cases import one_cpu_thread  # noqa: F401


def _clouds(seed, n, d, m=None, shift=0.5, scale=1.3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, d)).astype(np.float32)
    y = (shift + scale * r.standard_normal((m or n, d))).astype(np.float32)
    return x, y


def _gauss(seed, d):
    r = np.random.default_rng(seed)
    a = r.standard_normal((d, d))
    cov = (a @ a.T / d + 0.5 * np.eye(d)).astype(np.float32)
    return r.standard_normal(d).astype(np.float32), cov


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_w2_empirical_1d():
    x, y = _clouds(0, 500, 1)
    np.testing.assert_allclose(float(tm.w2_empirical_1d(*_t(x, y))),
                               float(jm.w2_empirical_1d(*_j(x, y))), rtol=1e-6)


@pytest.mark.parametrize("d", [1, 2, 5])
def test_gaussian_w2(d):
    (m1, c1), (m2, c2) = _gauss(d, d), _gauss(d + 10, d)
    got = float(tm.gaussian_w2(*_t(m1, c1, m2, c2)))
    want = float(jm.gaussian_w2(*_j(m1, c1, m2, c2)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a distribution is at distance ~0 from itself
    assert float(tm.gaussian_w2(*_t(m1, c1, m1, c1))) < 2e-3


@pytest.mark.parametrize("d", [1, 2, 5])
def test_w2_to_gaussian(d):
    x, _ = _clouds(d, 400, d)
    mu, cov = _gauss(d + 20, d)
    got = float(tm.w2_to_gaussian(*_t(x, mu, cov)))
    want = float(jm.w2_to_gaussian(*_j(x, mu, cov)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("debias", [True, False])
def test_sinkhorn_w2(debias):
    x, y = _clouds(3, 60, 2, m=50)
    got = float(tm.sinkhorn_w2(*_t(x, y), eps=0.1, num_iters=100, debias=debias))
    want = float(jm.sinkhorn_w2(*_j(x, y), eps=0.1, num_iters=100, debias=debias))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("d", [1, 3])
def test_gaussian_kl(d):
    (m1, c1), (m2, c2) = _gauss(d + 30, d), _gauss(d + 40, d)
    np.testing.assert_allclose(float(tm.gaussian_kl(*_t(m1, c1, m2, c2))),
                               float(jm.gaussian_kl(*_j(m1, c1, m2, c2))),
                               rtol=1e-5)


@pytest.mark.parametrize("d", [1, 3])
def test_kl_samples_to_gaussian(d):
    x, _ = _clouds(d + 50, 300, d)
    mu, cov = _gauss(d + 60, d)
    np.testing.assert_allclose(float(tm.kl_samples_to_gaussian(*_t(x, mu, cov))),
                               float(jm.kl_samples_to_gaussian(*_j(x, mu, cov))),
                               rtol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_knn_kl_estimate(k):
    x, y = _clouds(70 + k, 80, 2, m=90)
    np.testing.assert_allclose(float(tm.knn_kl_estimate(*_t(x, y), k=k)),
                               float(jm.knn_kl_estimate(*_j(x, y), k=k)),
                               rtol=1e-5, atol=1e-6)
