"""The sampler zoo of repro_torch against the JAX package, on the CPU: the
masked-batch oracle and the batch-scaled step size, SVRG, the
stale-gradient correction, SGHMC, the AR(1) stream, ``Sampler.step(keys=)``
and the unfused ``noise="jax"`` draw.

Tolerances: where both packages draw the same noise bits (sigma 0, or the
``noise="jax"`` draw) the trajectories agree within 1e-6 relative (float32
rounding of the gradients and of the multiply-adds XLA fuses); the
published-sigma regression chain within 1e-5 relative (its minibatch sums
and autodiff); pins inside the port are bitwise; the AR(1) stream within 4
ulps (it is bit for bit on every draw tested).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import samplers as jsamplers
from repro.core import Quadratic as JQuadratic
from repro.core import constant_delays as jconstant_delays
from repro.core import potentials as jpot
from repro.data import ar1_stream as jar1_stream
from repro.train import Engine as JEngine
from repro_torch import samplers
from repro_torch.core import Quadratic, constant_delays, potentials
from repro_torch.data import ar1_stream
from repro_torch.kernels import rng
from repro_torch.train.engine import Engine
from torch_cases import one_cpu_thread  # noqa: F401

GAMMA, SIGMA, STEPS, TAU, D = 0.01, 0.5, 60, 3, 4


def _quads():
    return (JQuadratic.make(jax.random.PRNGKey(0), d=D, m=1.0, L=3.0),
            Quadratic.make(rng.PRNGKey(0), d=D, m=1.0, L=3.0, device="cpu"))


def _batches(steps=STEPS, d=D, seed=5):
    return np.random.default_rng(seed).standard_normal((steps, 8, d)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _run_both(make_j, make_t, *, steps=STEPS, batches=None, delays=None, x0=0.0,
              chunk=7):
    """One chain in each package (the JAX Engine and the port's), from the
    same start, key, batches and delays; returns the final parameters."""
    batches = _batches(steps) if batches is None else batches
    delays = np.zeros(steps, np.int32) if delays is None else delays
    js, ts = make_j(), make_t()
    jst = js.init(jnp.full((D,), x0, jnp.float32), jax.random.PRNGKey(1))
    jfin, _ = JEngine(js, chunk_size=chunk, collect_aux=False).run(
        jst, steps=steps, batches=jnp.asarray(batches), delays=delays)
    tst = ts.init(torch.full((D,), x0), rng.PRNGKey(1))
    tfin, _ = Engine(ts, chunk_size=chunk, collect_aux=False).run(
        tst, steps=steps, batches=torch.from_numpy(batches), delays=delays)
    return np.asarray(jfin.params), tfin.params.numpy()


# -- masked batches -------------------------------------------------------------
@pytest.mark.parametrize("size", [8, 5, 1])
def test_masked_mean_gradients_and_scaled_gamma_match_reference(size):
    jq, tq = _quads()
    data = _batches(1, seed=size)[0]  # (B=8, D)
    jmb = jsamplers.MaskedBatch(data=jnp.asarray(data), size=jnp.int32(size))
    tmb = samplers.MaskedBatch(data=torch.from_numpy(data), size=size)
    # masked_mean over the first `size` rows: 1e-6 relative (sum order)
    want = jsamplers.masked_mean(jnp.asarray(data), jnp.int32(size))
    got = samplers.masked_mean(torch.from_numpy(data), size)
    assert _rel(got, want) <= 1e-6
    np.testing.assert_array_equal(samplers.batch_mask(tmb).numpy(),
                                  np.asarray(jsamplers.batch_mask(jmb)))
    # the per-example oracle vmapped over the bucket, then masked-mean
    x = np.linspace(-1, 1, D).astype(np.float32)
    jctx = jsamplers.StepContext(
        params=jnp.asarray(x), x_hat=jnp.asarray(x), grads=None, noise=None,
        aux=None, gamma=jnp.float32(GAMMA), key_noise=None, key_delay=None,
        step=jnp.int32(0), delay=jnp.int32(0), batch=jmb)
    # the port's transforms take chains stacked: one chain is C = 1
    tctx = samplers.StepContext(
        params=torch.from_numpy(x)[None], x_hat=torch.from_numpy(x)[None],
        grads=None, noise=None, aux=None, gamma=np.full(1, GAMMA, np.float32),
        key_noise=[None], key_delay=[None], step=0, delay=np.zeros(1, np.int64),
        batch=[tmb])
    for jt, tt in ((jsamplers.masked_gradients(lambda p, e: jq.grad(p, None) + e),
                    samplers.masked_gradients(lambda p, e: tq.grad(p, None) + e)),
                   (jsamplers.batch_scaled_gamma(4), samplers.batch_scaled_gamma(4))):
        jout, _ = jt.update(jctx, ())
        tout, _ = tt.update(tctx, ())
        if tout.grads is not None:
            assert _rel(tout.grads[0], jout.grads) <= 1e-6
        # gamma * size / base in float32: equal
        assert np.float32(tout.gamma[0]) == np.float32(jout.gamma)


def test_masked_gradients_refuses_plain_batches_and_autograd_oracles():
    _, tq = _quads()
    t = samplers.masked_gradients(lambda p, e: tq.grad(p, None))
    ctx = samplers.StepContext(params=torch.zeros(1, D), x_hat=torch.zeros(1, D),
                               grads=None, noise=None, aux=None,
                               gamma=np.full(1, GAMMA, np.float32), key_noise=[None],
                               key_delay=[None], step=0, delay=np.zeros(1, np.int64),
                               batch=[torch.zeros(8, D)])
    with pytest.raises(TypeError, match="MaskedBatch"):
        t.update(ctx, ())
    reg = potentials.PolyRegression.make(rng.PRNGKey(0), device="cpu")
    t = samplers.masked_gradients(lambda p, e: reg.grad(p, e))
    mb = samplers.MaskedBatch(data=(torch.zeros(4, 1), torch.zeros(4)), size=3)
    with pytest.raises(TypeError, match="vmap"):
        t.update(ctx._replace(params=torch.zeros(1, 5), x_hat=torch.zeros(1, 5),
                              batch=[mb]), ())


# -- SVRG ---------------------------------------------------------------------------
def _svrg_fns(q):
    mean = torch.mean if isinstance(q, Quadratic) else jnp.mean
    grad = lambda p, b: q.grad(p, None) + 0.5 * mean(b, 0)  # noqa: E731
    return grad, lambda p: q.grad(p, None)


def test_svrg_anchor_refresh_across_chunks_bitwise_and_against_reference():
    """Refreshes every 16 commits land inside chunks and on their
    boundaries: chunk sizes 3 and 5 agree bitwise in the port, and the
    port matches the JAX package within 1e-6 relative at sigma 0."""
    jq, tq = _quads()
    delays = np.asarray(constant_delays(TAU, STEPS).delays)
    batches = _batches()

    def port(chunk):
        s = samplers.svrg("consistent", *_svrg_fns(tq), anchor_every=16,
                          gamma=GAMMA, sigma=SIGMA, tau=TAU)
        st = s.init(torch.zeros(D), rng.PRNGKey(1))
        fin, _ = Engine(s, chunk_size=chunk, collect_aux=False).run(
            st, steps=STEPS, batches=torch.from_numpy(batches), delays=delays)
        return fin.params

    assert torch.equal(port(3), port(5))
    want, got = _run_both(
        lambda: jsamplers.svrg("consistent", *_svrg_fns(jq), anchor_every=16,
                               gamma=GAMMA, sigma=0.0, tau=TAU),
        lambda: samplers.svrg("consistent", *_svrg_fns(tq), anchor_every=16,
                              gamma=GAMMA, sigma=0.0, tau=TAU),
        delays=delays, x0=1.0)
    assert _rel(got, want) <= 1e-6


def test_svrg_anchor_is_a_copy_under_the_fused_commit():
    """The fused commit updates the parameters in place: the anchor must
    be a copy of the iterate it was taken at, not an alias that drifts."""
    _, tq = _quads()
    s = samplers.Sampler(samplers.chain(
        samplers.svrg_gradients(*_svrg_fns(tq), anchor_every=4),
        samplers.fused_update(SIGMA)), gamma=GAMMA)
    st = s.init(torch.ones(D), rng.PRNGKey(1))
    assert st.inner[0].anchor.data_ptr() != st.params.data_ptr()
    batches = torch.from_numpy(_batches(3))
    st, _ = s.step(st, batches[0])  # step 0 re-anchors at the start point
    anchor = st.inner[0].anchor
    assert anchor.data_ptr() != st.params.data_ptr()
    assert torch.equal(anchor, torch.ones(D))
    st, _ = s.step(st, batches[1])  # commits in place; the anchor stays
    assert torch.equal(st.inner[0].anchor, torch.ones(D))
    assert not torch.equal(st.params, torch.ones(D))


def test_svrg_validates_anchor_every():
    with pytest.raises(ValueError, match="anchor_every"):
        samplers.svrg_gradients(lambda p, b: p, lambda p: p, anchor_every=0)


# -- stale correction -------------------------------------------------------------
@pytest.mark.parametrize("mode", ["sync", "consistent"])
def test_stale_correction_bitwise_plain_sgld_at_zero_staleness(mode):
    _, tq = _quads()
    grad = lambda p, b: tq.grad(p, None)  # noqa: E731
    kw = dict(gamma=GAMMA, sigma=SIGMA, tau=TAU if mode != "sync" else 0)
    batches = torch.from_numpy(_batches())
    out = []
    for extra in ({}, dict(stale_strength=1.0, stale_gamma_scale=0.5)):
        s = samplers.sgld(mode, grad, **kw, **extra)
        _, traj = s.run(s.init(torch.zeros(D), rng.PRNGKey(2)), batches,
                        np.zeros(STEPS, np.int32))
        out.append(traj)
    assert torch.equal(out[0], out[1])


def test_stale_correction_under_delays_matches_reference():
    """Under a delay trace both terms act: within 1e-6 of the JAX package
    (``noise="jax"``, so both draw the same noise)."""
    jq, tq = _quads()
    delays = np.asarray(jconstant_delays(TAU, STEPS).delays)
    kw = dict(gamma=GAMMA, sigma=SIGMA, tau=TAU, stale_strength=0.5,
              stale_gamma_scale=0.2)
    want, got = _run_both(
        lambda: jsamplers.sgld("consistent", lambda p, b: jq.grad(p, None), **kw),
        lambda: samplers.sgld("consistent", lambda p, b: tq.grad(p, None),
                              noise="jax", **kw),
        delays=delays, x0=2.0)
    assert _rel(got, want) <= 1e-6
    plain, _ = _run_both(
        lambda: jsamplers.sgld("consistent", lambda p, b: jq.grad(p, None),
                               gamma=GAMMA, sigma=SIGMA, tau=TAU),
        lambda: samplers.sgld("consistent", lambda p, b: tq.grad(p, None),
                              gamma=GAMMA, sigma=SIGMA, tau=TAU, noise="jax"),
        delays=delays, x0=2.0)
    assert _rel(plain, want) > 1e-4  # the correction changed the chain


def test_stale_correction_requires_gradients():
    s = samplers.Sampler(samplers.chain(samplers.stale_correction()), gamma=GAMMA)
    with pytest.raises(ValueError, match="gradients"):
        s.step(s.init(torch.zeros(2), rng.PRNGKey(0)), torch.zeros(1), delay=1)


# -- SGHMC ----------------------------------------------------------------------------
@pytest.mark.parametrize("precond", [None, 0.25, "tree"])
@pytest.mark.parametrize("sigma", [0.0, SIGMA])
def test_sghmc_momentum_and_preconditioner_match_reference(precond, sigma):
    """SGHMC's momentum through 60 W-Con commits, with no, a scalar and a
    params-shaped preconditioner: within 1e-6 relative of the JAX package
    at sigma 0, and at sigma > 0 through ``noise="jax"``."""
    jq, tq = _quads()
    pj = pt = precond
    if precond == "tree":
        p = np.linspace(0.2, 1.5, D).astype(np.float32)
        pj, pt = jnp.asarray(p), torch.from_numpy(p)
    delays = np.asarray(jconstant_delays(TAU, STEPS).delays)
    kw = dict(gamma=GAMMA, sigma=sigma, friction=2.0, tau=TAU)
    want, got = _run_both(
        lambda: jsamplers.sghmc("consistent", lambda p, b: jq.grad(p, None),
                                precond=pj, **kw),
        lambda: samplers.sghmc("consistent", lambda p, b: tq.grad(p, None),
                               precond=pt, noise="jax", **kw),
        delays=delays, x0=3.0)
    assert _rel(got, want) <= 1e-6


def test_sghmc_state_and_validation():
    _, tq = _quads()
    s = samplers.sghmc("sync", lambda p, b: tq.grad(p, None), gamma=GAMMA)
    st = s.init(torch.zeros(D), rng.PRNGKey(0))
    assert st.inner[-1].shape == (D,) and not st.inner[-1].any()
    with pytest.raises(ValueError, match="friction"):
        samplers.sghmc_update(SIGMA, friction=0.0)
    with pytest.raises(ValueError, match="noise"):
        samplers.sghmc_update(SIGMA, noise="philox")


def test_svrg_matches_reference_at_sigma_through_jax_noise():
    jq, tq = _quads()
    delays = np.asarray(jconstant_delays(TAU, STEPS).delays)
    want, got = _run_both(
        lambda: jsamplers.svrg("consistent", *_svrg_fns(jq), anchor_every=16,
                               gamma=GAMMA, sigma=SIGMA, tau=TAU),
        lambda: samplers.svrg("consistent", *_svrg_fns(tq), anchor_every=16,
                              gamma=GAMMA, sigma=SIGMA, tau=TAU, noise="jax"),
        delays=delays, x0=1.0)
    assert _rel(got, want) <= 1e-6


# -- the AR(1) stream -------------------------------------------------------------
@pytest.mark.parametrize("rho,mean,scale", [(0.9, 0.0, 1.0), (0.5, 1.5, 2.0),
                                            (0.0, -0.3, 0.7)])
def test_ar1_stream_matches_reference(rho, mean, scale):
    want = np.asarray(jar1_stream(jax.random.PRNGKey(11), steps=40, batch=4, d=3,
                                  rho=rho, mean=mean, scale=scale))
    got = ar1_stream((0, 11), steps=40, batch=4, d=3, rho=rho, mean=mean,
                     scale=scale, device="cpu").numpy()
    assert got.shape == want.shape == (40, 4, 3)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4
    with pytest.raises(ValueError, match="rho"):
        ar1_stream((0, 1), steps=2, batch=1, d=1, rho=1.0, device="cpu")


# -- Sampler.step(keys=) ----------------------------------------------------------
def test_step_with_explicit_keys_leaves_the_carried_key():
    _, tq = _quads()
    s = samplers.sgld("sync", lambda p, b: tq.grad(p, None), gamma=GAMMA,
                      sigma=SIGMA)
    st = s.init(torch.zeros(D), rng.PRNGKey(3))
    keys = (rng.PRNGKey(7), rng.PRNGKey(8))
    a, _ = s.step(st, None, keys=keys)
    assert a.key == st.key and a.step == 1
    b, _ = s.step(st, None, keys=keys)
    assert torch.equal(a.params, b.params)  # the keys decide the noise
    c, _ = s.step(st, None)
    assert c.key == rng.split(st.key, 3)[0]
    assert not torch.equal(a.params, c.params)


# -- the published-sigma regression chain through noise="jax" ---------------------
def test_jax_noise_regression_chain_matches_reference_at_published_sigma():
    """W-Con at the regression's published gamma 2e-4 and sigma 1e-3, 400
    commits, batch 64: with ``noise="jax"`` the port draws the JAX
    package's noise, so the trajectories agree within 1e-5 relative (the
    factor-5.6 band of the default draw is not needed), relative to the
    trajectory's largest coordinate (a coordinate crossing zero has no
    elementwise relative error to speak of)."""
    jreg = jpot.PolyRegression.make(jax.random.PRNGKey(0), nu_std=0.1)
    treg = potentials.PolyRegression.make(rng.PRNGKey(0), nu_std=0.1, device="cpu")
    mu = np.array(jreg.posterior_moments(num=20_000, sigma=1e-3)[0])
    n, tau = 400, 16
    from repro.core import WorkerModel as JWorkerModel
    from repro.core import simulate_async as jsimulate_async
    delays = np.minimum(jsimulate_async(JWorkerModel(num_workers=8), n).delays, tau)
    kw = dict(gamma=2e-4, sigma=1e-3, tau=tau)
    js = jsamplers.sgld("consistent", lambda p, k: jax.grad(jreg.value)(
        p, jreg.sample_batch(k, 64)), **kw)
    ts = samplers.sgld("consistent", lambda p, k: treg.grad(p, treg.sample_batch(k, 64)),
                       noise="jax", **kw)
    _, jtraj = jax.jit(lambda s: js.run(s, jax.random.split(jax.random.PRNGKey(2), n),
                                        delays))(js.init(jnp.asarray(mu + 1.0),
                                                         jax.random.PRNGKey(1)))
    _, traj = ts.run(ts.init(torch.from_numpy(mu + 1.0), rng.PRNGKey(1)),
                     rng.split(rng.PRNGKey(2), n), delays)
    jtraj = np.asarray(jtraj)
    assert np.isfinite(traj.numpy()).all()
    assert _rel(traj.numpy(), jtraj) <= 1e-5
    assert (np.abs(np.diff(jtraj, axis=0)).max(axis=1) > 0).all()
