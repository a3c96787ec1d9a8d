"""The port's SGLD slice against the JAX package, on the CPU.

- The ring buffer's push and reads equal JAX's bit for bit.
- The copied delay model (``simulate_async`` with and without a
  ``FaultPlan``, ``simulate_sync``, ``constant_delays``) equals the JAX
  package's bit for bit.
- The LM loss and its gradients on the reduced qwen3-4b in float32 (2
  layers, d_model 256, vocab 512; one chain; weights carried over from
  the JAX init) agree with ``jax.value_and_grad``: the loss within rtol
  1e-5, the gradients within rtol 1e-5 / atol 1e-5 (the largest entries
  are ~0.3; the same fp32 math, only the summation order of the matmuls
  and of the embedding gradient's scatter-add differs).
- ``sgld`` in all four modes agrees with the JAX sampler commit by commit
  (3 commits, delays 0-2): loss within 1e-5 and parameters within 1e-6.
  The fused modes run with noise on (sigma 0.5): the noise bits, seeds and
  leaf order are the JAX package's, the normals within 1e-6 of its; the
  W-Icon delays are its delays bit for bit.  The unfused modes run at
  sigma 0, because the port's unfused noise is a ``torch.Generator``
  draw, not ``jax.random.normal``'s numbers.
- The deprecated ``SGLDSampler`` shim: in all four modes its trajectory
  equals ``samplers.sgld(mode)``'s bit for bit under the same key (noise
  on), and on a ``Quadratic`` at sigma 0 it agrees with the JAX shim
  commit by commit within 1e-6, its aux (the loss) too; it warns;
  ``SGLDConfig.gamma_at`` and ``make_minibatch_grad`` agree with the JAX
  package's.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import samplers as jsamplers
from repro.configs import get_reduced as jax_reduced
from repro.core import delay as jdelay
from repro.core import delay_model as jdm
from repro.core import schedules as jschedules
from repro.core import sgld as jsgld
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import loss_fn as jax_loss_fn
from repro.train.loop import make_grad_fn as jax_grad_fn
from repro_torch import samplers
from repro_torch.configs import get_reduced
from repro_torch.core import delay, delay_model, schedules, sgld
from repro_torch.kernels import rng
from repro_torch.models.transformer import Model, loss_fn
from repro_torch.samplers.transform import one_chain
from repro_torch.train.loop import make_grad_fn
from repro_torch.utils import tree_leaves
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

GAMMA = 1e-3


@pytest.fixture(scope="module")
def setup():
    jcfg = replace(jax_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    r = np.random.default_rng(0)
    batches = [{"tokens": r.integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)}
               for _ in range(3)]
    return jcfg, tcfg, jp, batches


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(jtree, ttree, atol, rtol=0.0):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b[0].detach().numpy(), np.asarray(a),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# ring buffer
# ---------------------------------------------------------------------------
def test_ring_push_and_reads_equal_jax():
    r = np.random.default_rng(1)
    p0 = {"b": r.standard_normal((3, 4)).astype(np.float32),
          "a": r.standard_normal((5,)).astype(np.float32)}
    jring = jdelay.init_ring(p0, 3)
    # one chain's ring, read as the chain-stacked ring of C = 1
    ring = one_chain(delay.init_ring({k: torch.from_numpy(v) for k, v in p0.items()}, 3))
    for k in range(6):  # wraps the 4-slot ring
        p = {n: r.standard_normal(v.shape).astype(np.float32) for n, v in p0.items()}
        jring = jdelay.push(jring, p)
        ring = delay.push(ring, {n: torch.from_numpy(v)[None] for n, v in p.items()})
        assert ring.head == int(jring.head)
        for d in range(5):  # 4 clamps to depth - 1
            want = jdelay.read_consistent(jring, jnp.int32(d))
            got = delay.read_consistent(ring, [d])
            for n in p0:
                np.testing.assert_array_equal(got[n][0].numpy(), np.asarray(want[n]))
        dl = {n: r.integers(0, 4, v.shape).astype(np.int32) for n, v in p0.items()}
        want = jdelay.read_inconsistent(jring, dl)
        got = delay.read_inconsistent(ring, {n: torch.from_numpy(v)[None]
                                             for n, v in dl.items()})
        for n in p0:
            np.testing.assert_array_equal(got[n][0].numpy(), np.asarray(want[n]))
    assert delay.ring_depths((ring, ())) == [4]
    with pytest.raises(delay.StalenessError):
        delay.validate_staleness(4, ((), ring))


# ---------------------------------------------------------------------------
# delay model
# ---------------------------------------------------------------------------
def _assert_traces_equal(a, b):
    for f in ("delays", "commit_times", "worker_ids", "batch_sizes", "alive"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_simulate_async_equals_jax_bitwise(seed):
    for mod, out in ((jdm, []), (delay_model, [])):
        out.append(mod.simulate_async(mod.WorkerModel(num_workers=8, seed=seed),
                                      200, seed=seed))
        out.append(mod.simulate_async(
            mod.WorkerModel(num_workers=4, seed=seed), 100, seed=seed,
            batch_policy="inverse-speed", base_batch=4))
        out.append(mod.simulate_sync(mod.WorkerModel(num_workers=8, seed=seed),
                                     50, seed=seed))
        out.append(mod.constant_delays(3, 20))
        if mod is jdm:
            want = out
        else:
            got = out
    for a, b in zip(want, got):
        _assert_traces_equal(a, b)


def test_simulate_async_with_fault_plan_equals_jax_bitwise():
    kw = dict(crash_rate=0.05, mean_downtime=2.0, pause_rate=0.1, mean_pause=1.0)
    want = jdm.simulate_async(jdm.WorkerModel(num_workers=8, seed=3,
                                              faults=jdm.FaultPlan(**kw)), 300, seed=3)
    got = delay_model.simulate_async(delay_model.WorkerModel(
        num_workers=8, seed=3, faults=delay_model.FaultPlan(**kw)), 300, seed=3)
    assert got.num_lost > 0
    _assert_traces_equal(want, got)


@pytest.mark.parametrize("name,args", [
    ("constant", (1e-3,)),
    ("poly_decay", (0.1, 0.55, 2.0)),
    ("wsd", (0.05, 5, 10, 20, 0.1)),
], ids=["constant", "poly_decay", "wsd"])
def test_schedules_match_jax_in_float32(name, args):
    """Host float32 schedules: equal to JAX's device float32 values within
    2 ulp (``pow`` is numpy's, not XLA's)."""
    jfn, tfn = getattr(jschedules, name)(*args), getattr(schedules, name)(*args)
    warm = (schedules.linear_warmup(tfn, 4), jschedules.linear_warmup(jfn, 4))
    cap = (schedules.clip_to_theory(tfn, 0.02), jschedules.clip_to_theory(jfn, 0.02))
    for step in range(40):
        for t, j in ((tfn, jfn), warm, cap):
            got, want = t(step), np.asarray(j(jnp.int32(step)))
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def test_loss_and_grads_match_jax_value_and_grad(setup):
    jcfg, tcfg, jp, batches = setup
    b = batches[0]
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jax_loss_fn(JaxModel(jcfg, mesh=None), p,
                              {"tokens": jnp.asarray(b["tokens"])}),
        has_aux=True)(jp)
    tp = from_jax_params(_host(jp), device="cpu")
    model = Model(tcfg, device="cpu")
    with torch.no_grad():
        tl, tm = loss_fn(model, tp, b)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    grads, metrics = make_grad_fn(model)(tp, b)
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=1e-5)
    _assert_tree_close(jg, grads, atol=1e-5, rtol=1e-5)
    assert all(not t.requires_grad for t in tree_leaves(tp))


def test_microbatched_grads_match_jax(setup):
    jcfg, tcfg, jp, batches = setup
    b = {"tokens": np.concatenate([batches[0]["tokens"], batches[1]["tokens"]])}
    jg, jm = jax_grad_fn(JaxModel(jcfg, mesh=None), 2)(
        jp, {"tokens": jnp.asarray(b["tokens"])})
    tg, tm = make_grad_fn(Model(tcfg, device="cpu"), 2)(
        from_jax_params(_host(jp), device="cpu"), b)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_tree_close(jg, tg, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the sampler, commit by commit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", ["sync", "consistent", "inconsistent", "pipeline"])
def test_sgld_commits_match_jax(setup, mode, fused):
    jcfg, tcfg, jp, batches = setup
    sigma = 0.5 if fused else 0.0
    kw = dict(gamma=GAMMA, sigma=sigma, tau=2 if mode in ("consistent",
                                                          "inconsistent") else 0,
              has_aux=True, fused=fused)
    js = jsamplers.sgld(mode, jax_grad_fn(JaxModel(jcfg, mesh=None)), **kw)
    ts = samplers.sgld(mode, make_grad_fn(Model(tcfg, device="cpu")), **kw)
    jstate = js.init(jp, jax.random.PRNGKey(3))
    tstate = ts.init(from_jax_params(_host(jp), device="cpu"), rng.PRNGKey(3))
    jstep = jax.jit(js.step)
    for b, d in zip(batches, (0, 1, 2)):
        jstate, jaux = jstep(jstate, {"tokens": jnp.asarray(b["tokens"])}, d)
        tstate, taux = ts.step(tstate, b, d)
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                                   rtol=1e-5)
        _assert_tree_close(jstate.params, tstate.params, atol=1e-6)
        assert tstate.step == int(jstate.step)
        assert tstate.key == tuple(np.asarray(jstate.key).tolist())


# ---------------------------------------------------------------------------
# the deprecated SGLDSampler shim
# ---------------------------------------------------------------------------
SHIM_STEPS = 12
SHIM_TAU = {"sync": 0, "consistent": 3, "inconsistent": 3, "pipeline": 0}


@pytest.fixture(scope="module")
def quads():
    from repro.core import Quadratic as JQuadratic
    from repro_torch.core import Quadratic

    jq = JQuadratic.make(jax.random.PRNGKey(0), d=4, m=1.0, L=3.0)
    tq = Quadratic(x_star=torch.from_numpy(np.array(jq.x_star)),
                   diag=torch.from_numpy(np.array(jq.diag)))
    return jq, tq


def _shim_delays(tau):
    return np.asarray(delay_model.constant_delays(tau, SHIM_STEPS).delays
                      if tau else np.zeros(SHIM_STEPS, np.int32))


@pytest.mark.parametrize("mode", ["sync", "consistent", "inconsistent", "pipeline"])
def test_shim_equals_preset_bitwise(quads, mode):
    _, tq = quads
    cfg = sgld.SGLDConfig(mode=mode, gamma=0.05, sigma=0.5, tau=SHIM_TAU[mode])
    grad = lambda p, b: tq.grad(p, b)  # noqa: E731
    with pytest.warns(DeprecationWarning):
        shim = sgld.SGLDSampler(cfg, grad)
    preset = samplers.sgld(mode, grad, gamma=0.05, sigma=0.5, tau=SHIM_TAU[mode])
    delays = _shim_delays(SHIM_TAU[mode])
    batches = torch.zeros((SHIM_STEPS, 1))
    s1, t1 = shim.run(shim.init(torch.zeros(4), rng.PRNGKey(2)), batches, delays)
    s2, t2 = preset.run(preset.init(torch.zeros(4), rng.PRNGKey(2)), batches, delays)
    assert torch.equal(t1, t2) and torch.equal(s1.params, s2.params)
    assert s1.key == s2.key and s1.step == s2.step == SHIM_STEPS
    assert not torch.equal(t1[0], t1[-1])  # the chain moved


@pytest.mark.parametrize("mode", ["sync", "consistent", "inconsistent", "pipeline"])
def test_shim_matches_jax_shim_at_sigma0(quads, mode):
    """Commit by commit on a Quadratic at sigma 0 (only float arithmetic
    differs): the iterate within 1e-6, the aux loss within 1e-6."""
    jq, tq = quads
    tau = SHIM_TAU[mode]
    kw = dict(mode=mode, gamma=0.05, sigma=0.0, tau=tau)
    with pytest.warns(DeprecationWarning):
        js = jsgld.SGLDSampler(jsgld.SGLDConfig(**kw),
                               lambda p, b: (jq.grad(p, b), {"loss": jq.value(p, b)}),
                               has_aux=True)
    with pytest.warns(DeprecationWarning):
        ts = sgld.SGLDSampler(sgld.SGLDConfig(**kw),
                              lambda p, b: (tq.grad(p, b), {"loss": tq.value(p, b)}),
                              has_aux=True)
    assert js.has_aux and ts.has_aux
    x0 = np.linspace(-1.0, 2.0, 4, dtype=np.float32)
    jstate = js.init(jnp.asarray(x0), jax.random.PRNGKey(5))
    tstate = ts.init(torch.from_numpy(x0), rng.PRNGKey(5))
    jstep = jax.jit(js.step)
    for d in _shim_delays(tau):
        jstate, jaux = jstep(jstate, None, int(d))
        tstate, taux = ts.step(tstate, None, int(d))
        np.testing.assert_allclose(tstate.params.numpy(), np.asarray(jstate.params),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                                   rtol=1e-6, atol=1e-6)
        assert tstate.key == tuple(np.asarray(jstate.key).tolist())
    assert float(np.abs(np.asarray(jstate.params) - x0).max()) > 0.1


def test_shim_surface_matches_jax():
    """The exports, the aliases, ``SGLDConfig.gamma_at`` (a constant and a
    schedule) and ``make_minibatch_grad`` against the JAX package's."""
    from repro.core import PolyRegression as JPolyRegression
    from repro_torch import core
    from repro_torch.core import PolyRegression
    from repro_torch.samplers.transforms import noise_like, sgld_apply

    assert core.SGLDSampler is sgld.SGLDSampler
    assert core.SGLDState is sgld.SGLDState is samplers.SamplerState
    assert core.make_minibatch_grad is sgld.make_minibatch_grad
    assert sgld.langevin_noise is noise_like and sgld.apply_update is sgld_apply
    for gamma, jgamma in ((0.05, 0.05),
                          (schedules.poly_decay(0.1, alpha=0.4, t0=10.0),
                           jschedules.poly_decay(0.1, alpha=0.4, t0=10.0))):
        tc = sgld.SGLDConfig(gamma=gamma)
        jc = jsgld.SGLDConfig(gamma=jgamma)
        for step in (0, 1, 7, 1000):
            got, want = tc.gamma_at(step), np.asarray(jc.gamma_at(jnp.int32(step)))
            assert got.dtype == np.float32 and got == want, (step, got, want)
    jreg = JPolyRegression.make(jax.random.PRNGKey(0), nu_std=0.1)
    reg = PolyRegression.make(rng.PRNGKey(0), nu_std=0.1, device="cpu")
    jbatch = jreg.sample_batch(jax.random.PRNGKey(1), 64)
    batch = tuple(torch.from_numpy(np.array(b)) for b in jbatch)
    w = np.asarray([0.3, -0.2, 0.1, 0.05, 0.4], np.float32)
    want = np.asarray(jsgld.make_minibatch_grad(jreg)(jnp.asarray(w), jbatch))
    got = sgld.make_minibatch_grad(reg)(torch.from_numpy(w), batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), reg.grad(torch.from_numpy(w), batch).numpy(),
                               rtol=1e-5, atol=1e-6)
