"""repro_torch's problem draws, potentials and theory against the JAX
package, on the CPU.

- ``jax_uniform`` equals ``jax.random.uniform`` bit for bit (the same
  mantissa bits, the multiply-add fused as XLA fuses it).
- ``jax_normal`` is within 4 ulps of ``jax.random.normal``, and bit for
  bit on at least 99% of the draws (it computes XLA's own ``erf_inv``,
  ``log1p`` and ``log``; on this CPU every draw tested is equal).
- The potentials' problems (``make`` / ``init_params``) within 4 ulps,
  minibatches, values and gradients within float32 tolerances stated per
  test (the sums and the autodiff run in another order), the numpy
  posterior moments as the reference's float32 casts of the same numbers.
- ``theory`` is a copy: equal to the last float.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import potentials as jpot
from repro.core import theory as jtheory
from repro_torch.core import potentials as pot
from repro_torch.core import theory
from repro_torch.kernels import rng
from torch_cases import one_cpu_thread  # noqa: F401

SHAPES = [(), (1,), (4,), (256,), (3, 4, 4)]
KEYS = [(0, 0), (0, 3), (0x13198A2E, 0x03707344)]


def _jkey(key):
    return jax.random.wrap_key_data(np.asarray(key, np.uint32))


def _ulps(a, b):
    """|a - b| in float32 ulps (a signed-magnitude order on the bits)."""
    def order(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(order(a) - order(b))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# jax.random.uniform / normal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (0.3, 1.7),
                                   (0.0, 2 * np.pi)])
def test_jax_uniform_bit_for_bit(shape, lo, hi):
    for key in KEYS:
        want = np.asarray(jax.random.uniform(_jkey(key), shape, minval=lo,
                                             maxval=hi))
        got = _np(rng.jax_uniform(key, shape, lo, hi))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_jax_normal_within_4_ulps(shape):
    for key in KEYS:
        want = np.asarray(jax.random.normal(_jkey(key), shape))
        got = _np(rng.jax_normal(key, shape))
        assert got.shape == want.shape and got.dtype == np.float32
        assert _ulps(got, want).max() <= 4


def test_jax_normal_many_draws():
    """2^16 draws: within 4 ulps, and bit for bit on 99% or more (both
    branches of erf_inv, both of log1p)."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1 << 16,)))
    got = _np(rng.jax_normal(rng.PRNGKey(3), (1 << 16,)))
    d = _ulps(got, want)
    assert d.max() <= 4
    assert (d == 0).mean() >= 0.99


def test_scalar_draw_is_element_zero():
    for key in KEYS:
        assert rng.jax_normal(key, ()).item() == rng.jax_normal(key, (1,))[0].item()
        assert (rng.jax_uniform(key, (), -1.0, 1.0).item()
                == rng.jax_uniform(key, (1,), -1.0, 1.0)[0].item())


def test_split_many_keys_equals_jax():
    """``split`` into one key per commit, as the experiments split."""
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.PRNGKey(2), 300)))
    got = np.asarray(rng.split(rng.PRNGKey(2), 300), np.uint32)
    np.testing.assert_array_equal(got, want)
    assert rng.split(rng.PRNGKey(2), 300)[:3] == rng.split(rng.PRNGKey(2), 3)


# ---------------------------------------------------------------------------
# potentials
# ---------------------------------------------------------------------------
def test_quadratic_matches_reference():
    jq = jpot.Quadratic.make(jax.random.PRNGKey(1), 6, grad_noise=0.3)
    tq = pot.Quadratic.make(rng.PRNGKey(1), 6, grad_noise=0.3, device="cpu")
    assert _ulps(_np(tq.x_star), jq.x_star).max() <= 4
    assert _ulps(_np(tq.diag), jq.diag).max() <= 4
    assert (tq.d, tq.m, tq.L) == (jq.d, jq.m, jq.L)
    x = np.random.default_rng(0).standard_normal(6).astype(np.float32)
    np.testing.assert_allclose(float(tq.value(torch.from_numpy(x))),
                               float(jq.value(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(_np(tq.grad(torch.from_numpy(x))),
                               np.asarray(jq.grad(jnp.asarray(x))), rtol=1e-6)
    # the gradient noise is jax.random.normal's (within 4 ulps)
    np.testing.assert_allclose(
        _np(tq.grad(torch.from_numpy(x), key=rng.PRNGKey(7))),
        np.asarray(jq.grad(jnp.asarray(x), key=jax.random.PRNGKey(7))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tq.stationary_cov(0.5)),
                               np.asarray(jq.stationary_cov(0.5)), rtol=1e-6)
    assert tq.sample_batch(rng.PRNGKey(0), 4) is None
    one = pot.Quadratic.make(rng.PRNGKey(1), 1, device="cpu")
    assert _np(one.diag).tolist() == [0.5]


def test_poly_regression_problem_and_batches():
    jr = jpot.PolyRegression.make(jax.random.PRNGKey(0), nu_std=0.1)
    tr = pot.PolyRegression.make(rng.PRNGKey(0), nu_std=0.1, device="cpu")
    assert _ulps(_np(tr.true_coef), jr.true_coef).max() <= 4
    assert _ulps(np.float32(tr.true_bias), np.float32(jr.true_bias)).max() <= 4
    jphi, jy = jr.sample_batch(jax.random.PRNGKey(5), 256)
    phi, y = tr.sample_batch(rng.PRNGKey(5), 256)
    np.testing.assert_array_equal(_np(phi), np.asarray(jphi))
    # the 4-term dot product sums in another order: a few float32 ulps
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-6, atol=1e-6)


def test_poly_regression_value_grad_and_posterior():
    jr = jpot.PolyRegression.make(jax.random.PRNGKey(0), nu_std=0.1)
    tr = pot.PolyRegression.make(rng.PRNGKey(0), nu_std=0.1, device="cpu")
    jb = jr.sample_batch(jax.random.PRNGKey(5), 256)
    tb = tuple(torch.from_numpy(np.array(a)) for a in jb)  # same batch
    w = np.random.default_rng(1).standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(float(tr.value(torch.from_numpy(w), tb)),
                               float(jr.value(jnp.asarray(w), jb)), rtol=1e-5)
    np.testing.assert_allclose(_np(tr.grad(torch.from_numpy(w), tb)),
                               np.asarray(jr.grad(jnp.asarray(w), jb)),
                               rtol=1e-5, atol=1e-4)
    for got, want in zip(tr.posterior_moments(num=20_000, sigma=1e-3),
                         jr.posterior_moments(num=20_000, sigma=1e-3)):
        assert got.dtype == torch.float32
        # float64 numpy on coefficients within 4 ulps, then cast
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-9)
    np.testing.assert_allclose(tr.constants(), jr.constants(), rtol=1e-5)
    assert tr.d == jr.d == 5


def test_rica_problem_batches_value_grad():
    jr = jpot.RICA(patch_dim=16, num_features=8)
    tr = pot.RICA(patch_dim=16, num_features=8, device="cpu")
    jw = jr.init_params(jax.random.PRNGKey(0))
    w = tr.init_params(rng.PRNGKey(0))
    # within 4 ulps before the normalisation, a few after it
    np.testing.assert_allclose(_np(w), np.asarray(jw), rtol=2e-6, atol=1e-7)
    jx = jr.sample_batch(jax.random.PRNGKey(4), 64)
    x = tr.sample_batch(rng.PRNGKey(4), 64)
    assert x.shape == (64, 16) and x.dtype == torch.float32
    # cos/sin and the inverse FFT are ATen's, not XLA's: float32 rounding
    np.testing.assert_allclose(_np(x), np.asarray(jx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(x).std(axis=1), 1.0, rtol=1e-5)  # ddof 0
    xb = torch.from_numpy(np.array(jx))
    wt = torch.from_numpy(np.array(jw))
    np.testing.assert_allclose(float(tr.value(wt, xb)), float(jr.value(jw, jx)),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(tr.grad(wt, xb)), np.asarray(jr.grad(jw, jx)),
                               rtol=1e-4, atol=1e-6)
    assert tr.d == jr.d == 128
    with pytest.raises(ValueError, match="square"):
        pot.RICA(patch_dim=15, num_features=2, device="cpu").sample_batch(
            rng.PRNGKey(0), 2)


def test_neg_log_posterior_potential_on_a_tree():
    def jloss(p, b):
        return jnp.sum((p["a"] * b) ** 2) + jnp.sum(p["b"])

    def tloss(p, b):
        return torch.sum((p["a"] * b) ** 2) + torch.sum(p["b"])

    r = np.random.default_rng(2)
    p = {"a": r.standard_normal(3).astype(np.float32),
         "b": r.standard_normal((2, 2)).astype(np.float32)}
    b = r.standard_normal(3).astype(np.float32)
    for prec in (0.0, 0.7):
        want = jpot.neg_log_posterior_potential(jloss, prec)(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(b))
        got = pot.neg_log_posterior_potential(tloss, prec)(
            {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(b))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        pot.PolyRegression.make(rng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        pot.RICA(patch_dim=16, num_features=8).init_params(rng.PRNGKey(0))


# ---------------------------------------------------------------------------
# theory (pure Python: a copy, equal to the last float)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("consts", [
    dict(m=0.5, L=2.0, d=10, G=3.0, sigma=1.0, tau=0),
    dict(m=0.1, L=5.0, d=5, G=1.5, sigma=1e-3, tau=8, w2sq_0=4.0),
    dict(m=1.0, L=1.0, d=1, G=0.2, sigma=0.25, tau=16),
])
def test_theory_is_a_copy(consts):
    jc, tc = jtheory.ProblemConstants(**consts), theory.ProblemConstants(**consts)
    for eps in (1e-3, 0.05, 0.5):
        assert theory.gamma_terms(tc, eps) == jtheory.gamma_terms(jc, eps)
        for name in ("gamma_eps_kl", "n_eps_kl", "gamma_eps_w2", "n_eps_w2"):
            assert getattr(theory, name)(tc, eps) == getattr(jtheory, name)(jc, eps)
    for gamma in (1e-4, 1e-2):
        assert (theory.inconsistent_read_bias(tc, gamma)
                == jtheory.inconsistent_read_bias(jc, gamma))
