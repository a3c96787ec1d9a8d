"""The paper's experiment path in repro_torch against the JAX package, on
the CPU: ``Sampler.run``, the fused preset inside a chain, the §3.2
regression and §3.3 RICA experiments, and the reference fixture that
``chip_smoke.py`` holds the card's runs to.

- At sigma = 0 only float arithmetic differs between the packages (the
  problem, minibatches, delays and keys are the same bits): trajectories,
  W2, objectives and distances agree within the tolerances stated below;
  iterations, simulated times and speedups are equal exactly (the delay
  model is a bitwise copy).
- The fused preset at sigma > 0 draws the reference's noise bits (threefry
  and Box-Muller; ATen's log and cos differ from XLA's in the last ulp), and
  W-Icon's coordinate delays are the reference's bit for bit.
- At the published sigma the unfused noise is a ``torch.Generator`` draw,
  not ``jax.random.normal``'s numbers: a final W2 is held to the band the
  fixture's generator measured (``scripts/torch_paper_reference.py``).
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import samplers as jsamplers
from repro.core import delay as jdelay
from repro.core import potentials as jpot
from repro.core import simulate_async as jsimulate_async
from repro.core import WorkerModel as JWorkerModel
from repro.experiments import run_regression_experiment as jax_regression
from repro.experiments import run_rica_experiment as jax_rica
from repro_torch import samplers
from repro_torch.core import delay, potentials
from repro_torch.experiments import run_regression_experiment, run_rica_experiment
from repro_torch.kernels import rng
from repro_torch.samplers.transform import one_chain
from torch_cases import one_cpu_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_paper_reference.json"
N = 80  # commits of the Sampler.run tests
TAU = 4


def _problem():
    jreg = jpot.PolyRegression.make(jax.random.PRNGKey(0), nu_std=0.1)
    treg = potentials.PolyRegression.make(rng.PRNGKey(0), nu_std=0.1, device="cpu")
    mu = jreg.posterior_moments(num=20_000, sigma=1e-3)[0]
    return jreg, treg, np.array(mu)


def _delays(n=N, tau=TAU):
    return np.minimum(jsimulate_async(JWorkerModel(num_workers=8), n).delays, tau)


def _run_both(mode, *, sigma, fused, gamma=1e-3, n=N, tau=TAU):
    """One chain of ``n`` commits in each package from the same start,
    chain key, per-commit batch keys and delays."""
    jreg, treg, mu = _problem()

    def jgrad(p, key):
        return jax.grad(jreg.value)(p, jreg.sample_batch(key, 64))

    def tgrad(p, key):
        return treg.grad(p, treg.sample_batch(key, 64))

    t = tau if mode != "sync" else 0
    delays = _delays(n, tau) if mode != "sync" else np.zeros(n, np.int32)
    js = jsamplers.sgld(mode, jgrad, gamma=gamma, sigma=sigma, tau=t,
                        fused=fused)
    ts = samplers.sgld(mode, tgrad, gamma=gamma, sigma=sigma, tau=t, fused=fused)
    jkeys = jax.random.split(jax.random.PRNGKey(2), n)
    _, jtraj = jax.jit(lambda s: js.run(s, jkeys, delays))(
        js.init(jax.numpy.asarray(mu + 1.0), jax.random.PRNGKey(1)))
    state, traj = ts.run(ts.init(torch.from_numpy(mu + 1.0), rng.PRNGKey(1)),
                         rng.split(rng.PRNGKey(2), n), delays)
    return np.asarray(jtraj), traj, state


@pytest.mark.parametrize("mode", ["sync", "consistent", "inconsistent"])
def test_sampler_run_matches_reference_at_sigma_zero(mode):
    jtraj, traj, state = _run_both(mode, sigma=0.0, fused=False)
    assert traj.shape == (N, 5) and traj.dtype == torch.float32
    # float32 rounding of the minibatch sums and the autodiff, over 80
    # contracting commits
    np.testing.assert_allclose(traj.numpy(), jtraj, rtol=1e-5, atol=1e-6)
    assert torch.equal(traj[-1], state.params) and state.step == N


@pytest.mark.parametrize("mode", ["consistent", "inconsistent"])
def test_fused_preset_matches_reference_at_published_sigma(mode):
    """The fused commit's noise is the reference's threefry bits (sigma
    1e-3, gamma 2e-4: the regression's published values)."""
    jtraj, traj, _ = _run_both(mode, sigma=1e-3, gamma=2e-4, fused=True, tau=16)
    # ATen's log/cos against XLA's: the noise within 1e-6 before scaling
    np.testing.assert_allclose(traj.numpy(), jtraj, rtol=1e-5, atol=1e-6)
    # at sigma > 0 the chain moves on every commit
    assert (np.abs(np.diff(jtraj, axis=0)).max(axis=1) > 0).all()


def test_collect_copies_each_iterate_under_fused():
    """The fused commit updates the parameters in place: ``run`` must keep
    a copy of each iterate, not n views of the last one."""
    _, traj, state = _run_both("consistent", sigma=1e-3, gamma=2e-4,
                               fused=True, tau=16)
    steps = (traj[1:] - traj[:-1]).abs().amax(dim=1)
    assert bool((steps > 0).all())
    assert torch.equal(traj[-1], state.params)
    assert not torch.equal(traj[0], state.params)


def test_run_without_collect_and_without_delays():
    _, treg, mu = _problem()
    s = samplers.sgld("sync", lambda p, k: treg.grad(p, treg.sample_batch(k, 16)),
                      gamma=1e-3, sigma=0.0)
    keys = rng.split(rng.PRNGKey(2), 10)
    a, none = s.run(s.init(torch.from_numpy(mu), rng.PRNGKey(1)), keys,
                    collect=False)
    b, traj = s.run(s.init(torch.from_numpy(mu), rng.PRNGKey(1)), keys,
                    np.zeros(10, np.int32))
    assert none is None and torch.equal(a.params, b.params)
    assert torch.equal(traj[-1], a.params)
    with pytest.raises(ValueError, match="delays"):
        s.run(a, keys, [0, 0])


def test_wicon_coordinate_delays_along_the_chain():
    """Each commit's W-Icon delays, drawn from the chain's own delay keys,
    equal the reference's bit for bit."""
    jring = jdelay.init_ring(jax.numpy.zeros(5), 16)
    ring = one_chain(delay.init_ring(torch.zeros(5), 16))  # one chain: C = 1
    jkey, key = jax.random.PRNGKey(1), rng.PRNGKey(1)
    for d in _delays(40, 16):
        jkey, _, jk_delay = jax.random.split(jkey, 3)
        key, _, k_delay = rng.split(key, 3)
        want = jdelay.sample_coordinate_delays(jk_delay, jring, int(d))
        got = delay.sample_coordinate_delays([k_delay], ring, [int(d)])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the experiments at sigma = 0
# ---------------------------------------------------------------------------
def test_regression_experiment_matches_reference_at_sigma_zero():
    kw = dict(P=4, steps=400, sigma=0.0)
    want = jax_regression(**kw)
    got = run_regression_experiment(**kw, device="cpu")
    assert list(got) == list(want)
    for mode, w in want.items():
        g = got[mode]
        np.testing.assert_array_equal(g.iters, w.iters)
        np.testing.assert_array_equal(g.times, w.times)
        assert g.speedup == w.speedup
        # measured: traj 1.2e-7, W2 rel 6e-7 (float32 rounding)
        np.testing.assert_allclose(g.traj2d, w.traj2d, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.w2, w.w2, rtol=1e-5)


def test_rica_experiment_matches_reference_at_sigma_zero():
    kw = dict(patch_dim=16, num_features=8, steps=60, nu=0.0)
    want = jax_rica(**kw)
    got = run_rica_experiment(**kw, device="cpu")
    assert list(got) == list(want)
    for mode, w in want.items():
        g = got[mode]
        np.testing.assert_array_equal(g.iters, w.iters)
        np.testing.assert_array_equal(g.times, w.times)
        assert g.speedup == w.speedup
        # measured: objective 1.4e-6 abs (of ~7), distance 9e-8
        np.testing.assert_allclose(g.objective, w.objective, rtol=1e-5)
        np.testing.assert_allclose(g.dist_to_opt, w.dist_to_opt, rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the published sigma, and the fixture chip_smoke.py reads
# ---------------------------------------------------------------------------
def _fixture():
    return json.loads(FIXTURE.read_text())


def test_published_sigma_regression_in_band():
    """W-Icon at the published nu, gamma, sigma, batch and P over a quarter
    of the steps: the final W2 lies in the band the fixture's generator
    measured around the JAX package's value; the speedup is equal."""
    fx = _fixture()
    s = fx["settings"]["regression_test"]
    kw = {k: v for k, v in s.items() if k != "modes"}
    got = run_regression_experiment(**kw, modes=tuple(s["modes"]), device="cpu")
    for mode in s["modes"]:
        ref = fx["reference"]["regression_test"][mode]
        band = fx["band"]["regression_test"][mode]["w2"]
        assert abs(np.log(got[mode].w2[-1] / ref["w2"])) <= band
        assert got[mode].speedup == ref["speedup"]


def test_fixture_settings_are_what_chip_smoke_runs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    fx = _fixture()
    assert fx["settings"]["regression"] == chip_smoke.PUBLISHED["regression"]
    assert fx["settings"]["rica"] == chip_smoke.PUBLISHED["rica"]
    for name in ("regression", "rica"):
        for mode in fx["settings"][name]["modes"]:
            assert set(fx["band"][name][mode]) <= set(fx["reference"][name][mode])
            assert all(0 < b < np.inf for b in fx["band"][name][mode].values())
