"""The multi-chain cluster of repro_torch against the JAX package, on the
CPU, at the JAX tests' sizes (C 8 chains, 37 commits, tau 8, a d=4
``Quadratic``): the schedule copy, the worker keys, chain-by-chain parity
with the single-chain ``Engine``, the ``ClusterEngine`` under every batch
policy and zoo preset, the cross-chain diagnostics and the recorders.

Tolerances: inside the port, chain c of the ensemble equals the
single-chain ``Engine`` bit for bit.  Against the JAX package,
trajectories agree within 1e-6 relative to their largest coordinate
wherever both draw the same noise bits (sigma 0; the fused preset's
threefry noise; the unfused ``noise="jax"`` draw): float32 rounding of the
gradients and of the multiply-adds XLA fuses.  The schedules, keys, read
versions and recorders' steps, times and gradient counts are equal
exactly; split-R-hat, ESS and W2 agree within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import samplers as jsamplers
from repro.cluster import ClusterEngine as JClusterEngine
from repro.cluster import ensemble as jensemble
from repro.cluster import schedule as jschedule
from repro.core import Quadratic as JQuadratic
from repro.core import WorkerModel as JWorkerModel
from repro_torch import samplers
from repro_torch.cluster import (
    ClusterEngine,
    StalenessError,
    WorkerSchedule,
    diagnostics_recorder,
    ensemble_async,
    ensemble_w2,
    ess,
    split_rhat,
    w2_recorder,
    worker_keys,
)
from repro_torch.cluster import schedule
from repro_torch.core import FaultPlan, Quadratic, WorkerModel, constant_delays
from repro_torch.kernels import rng
from repro_torch.train.engine import Engine
from torch_cases import one_cpu_thread  # noqa: F401

C, STEPS, TAU, D = 8, 37, 8, 4
WM = dict(num_workers=4, seed=1)
HET = dict(num_workers=4, heterogeneity=0.6, update_cost=0.6, seed=1)


@pytest.fixture(scope="module")
def quads():
    return (JQuadratic.make(jax.random.PRNGKey(0), d=D, m=1.0, L=3.0),
            Quadratic.make(rng.PRNGKey(0), d=D, m=1.0, L=3.0, device="cpu"))


@pytest.fixture(scope="module")
def scheds():
    return (jschedule.ensemble_async(JWorkerModel(**WM), STEPS, C, seed=0),
            ensemble_async(WorkerModel(**WM), STEPS, C, seed=0))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- the schedule copy ----------------------------------------------------------------
@pytest.mark.parametrize("policy", ["fixed", "inverse-speed"])
def test_schedule_copy_equals_reference_array_for_array(policy):
    kw = dict(batch_policy=policy, base_batch=4)
    js = jschedule.ensemble_async(JWorkerModel(**HET), 50, 3, seed=7, **kw)
    ts = schedule.ensemble_async(WorkerModel(**HET), 50, 3, seed=7, **kw)
    for a, b in zip(js, ts):
        for f in ("read_versions", "worker_ids", "commit_times", "batch_sizes",
                  "delays", "data_offsets", "worker_slots", "grad_evals"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert a.max_delay == b.max_delay and a.num_lost == b.num_lost == 0
        w = a.with_batch_sizes(np.arange(1, 51) % 7 + 1)
        v = b.with_batch_sizes(np.arange(1, 51) % 7 + 1)
        assert np.array_equal(w.batch_sizes, v.batch_sizes)
        assert np.array_equal(a.to_trace().delays, b.to_trace().delays)
    for f in ("stack_schedules", "stack_batch_info", "stack_worker_info"):
        x = getattr(jschedule, f)(js, 40) if f != "stack_schedules" else \
            jschedule.stack_schedules(js, steps=40)
        y = getattr(schedule, f)(ts, 40) if f != "stack_schedules" else \
            schedule.stack_schedules(ts, steps=40)
        if x is None:
            assert y is None
            continue
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and np.array_equal(u, v), f
    assert schedule.stack_liveness(ts, 40) is None


def test_schedule_semantics():
    s = WorkerSchedule.from_delays(np.array([0, 1, 2, 3], np.int32))
    s.validate_ring(4)
    with pytest.raises(StalenessError):
        s.validate_ring(3)
    with pytest.raises(ValueError):
        WorkerSchedule(read_versions=np.array([0, 2], np.int32),
                       worker_ids=np.zeros(2, np.int32),
                       commit_times=np.arange(2, dtype=np.float64), num_workers=1)
    assert np.array_equal(WorkerSchedule.sync(5).delays, np.zeros(5, np.int32))


def test_fold_in_and_worker_keys_equal_jax():
    key = jax.random.PRNGKey(42)
    for data in (0, 1, 0x6A17, 0x5747_4E01, 2**32 - 1):
        assert rng.fold_in((0, 42), data) == tuple(
            int(v) for v in np.asarray(jax.random.fold_in(key, data)))
    for wid, slot in ((0, 0), (3, 17), (7, 2**20)):
        jn, jd = jensemble.worker_keys(key, jnp.int32(wid), jnp.int32(slot))
        tn, td = worker_keys((0, 42), wid, slot)
        assert tn == tuple(int(v) for v in np.asarray(jn))
        assert td == tuple(int(v) for v in np.asarray(jd))


# -- chain c == the single-chain Engine, bit for bit --------------------------------------
@pytest.mark.parametrize("mode,fused", [("consistent", False),
                                        ("inconsistent", False),
                                        ("inconsistent", True)],
                         ids=["wcon", "wicon", "wicon-fused"])
def test_chain_parity_bitwise_vs_single_chain_engine(quads, scheds, mode, fused):
    _, tq = quads
    s = samplers.sgld(mode, lambda p, b: tq.grad(p, b), gamma=0.01, sigma=0.5,
                      tau=TAU, fused=fused)
    engine = ClusterEngine(s, num_chains=C, chunk_size=10)
    key = rng.PRNGKey(42)
    state = engine.init(torch.zeros(D), key)
    assert state.inner[0].history.shape == (C, TAU + 1, D)
    state, _ = engine.run(state, steps=STEPS, schedule=scheds[1])
    assert state.step == STEPS
    for c, k in enumerate(rng.split(key, C)):
        st, _ = Engine(s, chunk_size=10).run(
            s.init(torch.zeros(D), k), steps=STEPS, batches=torch.zeros(STEPS, 1),
            delays=scheds[1][c].to_trace())
        assert torch.equal(st.params, state.params[c]), f"chain {c}"


def test_continuation_run_rebases_read_versions(quads, scheds):
    _, tq = quads
    s = samplers.sgld("consistent", lambda p, b: tq.grad(p, b), gamma=0.01,
                      sigma=0.5, tau=TAU)
    engine = ClusterEngine(s, num_chains=C, chunk_size=10)
    key = rng.PRNGKey(11)
    state = engine.init(torch.zeros(D), key)
    state, _ = engine.run(state, steps=20, schedule=scheds[1])
    state, _ = engine.run(state, steps=17, schedule=scheds[1])
    single = Engine(s, chunk_size=10)
    st = s.init(torch.zeros(D), rng.split(key, C)[2])
    for n in (20, 17):
        st, _ = single.run(st, steps=n, batches=torch.zeros(n, 1),
                           delays=scheds[1][2].to_trace())
    assert torch.equal(st.params, state.params[2])


def test_staleness_and_trace_count(quads, scheds):
    _, tq = quads
    shallow = samplers.sgld("consistent", lambda p, b: tq.grad(p, b), gamma=0.01,
                            sigma=0.5, tau=2)
    engine = ClusterEngine(shallow, num_chains=C, chunk_size=10)
    with pytest.raises(StalenessError, match="does not fit the iterate ring"):
        engine.run(engine.init(torch.zeros(D), rng.PRNGKey(0)), steps=20,
                   schedule=WorkerSchedule.from_trace(constant_delays(5, 20)))
    s = samplers.sgld("consistent", lambda p, b: tq.grad(p, b), gamma=0.01,
                      sigma=0.5, tau=TAU)
    engine = ClusterEngine(s, num_chains=C, chunk_size=10)
    engine.run(engine.init(torch.zeros(D), rng.PRNGKey(0)), steps=30,
               schedule=scheds[1])
    engine.run(engine.init(torch.zeros(D), rng.PRNGKey(1)), steps=30)
    assert engine.num_traces == 1


# -- ClusterEngine against the JAX package ---------------------------------------------
def _presets(jq, tq, name, sigma, **kw):
    jg, tg = (lambda p, b: jq.grad(p, b)), (lambda p, b: tq.grad(p, b))
    if name == "svrg":
        return (jsamplers.svrg("consistent", jg, lambda p: jq.grad(p, None),
                               anchor_every=5, gamma=0.01, sigma=sigma, tau=TAU),
                samplers.svrg("consistent", tg, lambda p: tq.grad(p, None),
                              anchor_every=5, gamma=0.01, sigma=sigma, tau=TAU,
                              noise="jax"))
    if name == "sghmc":
        return (jsamplers.sghmc("consistent", jg, gamma=0.01, sigma=sigma,
                                friction=2.0, tau=TAU),
                samplers.sghmc("consistent", tg, gamma=0.01, sigma=sigma,
                               friction=2.0, tau=TAU, noise="jax"))
    mode, fused = {"sgld": ("consistent", False), "wicon": ("inconsistent", False),
                   "fused": ("inconsistent", True)}[name]
    return (jsamplers.sgld(mode, jg, gamma=0.01, sigma=sigma, tau=TAU, fused=fused),
            samplers.sgld(mode, tg, gamma=0.01, sigma=sigma, tau=TAU, fused=fused,
                          noise="jax"))


def _both_engines(js, ts, scheds, *, run_kw=(), **ekw):
    je = JClusterEngine(js, num_chains=C, chunk_size=10, **ekw)
    te = ClusterEngine(ts, num_chains=C, chunk_size=10, **ekw)
    jst = je.init(jnp.zeros(D), jax.random.PRNGKey(2), jitter=1.0)
    tst = te.init(torch.zeros(D), rng.PRNGKey(2), jitter=1.0)
    np.testing.assert_array_equal(tst.params.numpy(), np.asarray(jst.params))
    run_kw = dict(run_kw)
    arrays = ("data", "batches")
    jdata = {k: (jnp.asarray(v) if k in arrays else v) for k, v in run_kw.items()}
    tdata = {k: (torch.from_numpy(v) if k in arrays else v) for k, v in run_kw.items()}
    jst, _ = je.run(jst, steps=STEPS, schedule=scheds[0], **jdata)
    tst, _ = te.run(tst, steps=STEPS, schedule=scheds[1], **tdata)
    return np.asarray(jst.params), tst.params.numpy(), je, te


@pytest.mark.parametrize("worker_rng", [False, True], ids=["split", "worker-rng"])
@pytest.mark.parametrize("name,sigma", [("sgld", 0.0), ("wicon", 0.0),
                                        ("svrg", 0.0), ("sghmc", 0.0),
                                        ("fused", 0.5), ("sgld", 0.5),
                                        ("svrg", 0.5), ("sghmc", 0.5)])
def test_cluster_engine_matches_reference(quads, scheds, name, sigma, worker_rng):
    js, ts = _presets(*quads, name, sigma)
    want, got, _, _ = _both_engines(js, ts, scheds, worker_rng=worker_rng)
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("policy", ["inverse-speed", "explicit"])
def test_masked_batch_policies_match_reference(quads, policy):
    jq, tq = quads
    js_ = jschedule.ensemble_async(JWorkerModel(**HET), STEPS, C, seed=0,
                                   batch_policy="inverse-speed", base_batch=4)
    ts_ = ensemble_async(WorkerModel(**HET), STEPS, C, seed=0,
                         batch_policy="inverse-speed", base_batch=4)
    tau = max(s.max_delay for s in ts_)
    data = np.random.default_rng(0).standard_normal((100, D)).astype(np.float32)
    run_kw = {"data": data}
    if policy == "explicit":
        run_kw["batch_sizes"] = np.random.default_rng(1).integers(1, 9, (STEPS, C))
    js = jsamplers.sgld("consistent", lambda p, e: jq.grad(p, None) + e,
                        gamma=0.02, sigma=0.5, tau=tau, base_batch=4)
    ts = samplers.sgld("consistent", lambda p, e: tq.grad(p, None) + e,
                       gamma=0.02, sigma=0.5, tau=tau, base_batch=4, noise="jax")
    hooks = (w2_recorder(np.zeros((16, D), np.float32), every=10),
             jensemble.w2_recorder(jnp.zeros((16, D)), every=10))
    je = JClusterEngine(js, num_chains=C, chunk_size=10, batch_policy=policy,
                        hooks=[hooks[1]])
    te = ClusterEngine(ts, num_chains=C, chunk_size=10, batch_policy=policy,
                       hooks=[hooks[0]])
    jst, _ = je.run(je.init(jnp.zeros(D), jax.random.PRNGKey(2), jitter=1.0),
                    steps=STEPS, schedule=js_, **{**run_kw, "data": jnp.asarray(data)})
    tst, _ = te.run(te.init(torch.zeros(D), rng.PRNGKey(2), jitter=1.0),
                    steps=STEPS, schedule=ts_, **{**run_kw, "data": torch.from_numpy(data)})
    assert _rel(tst.params.numpy(), np.asarray(jst.params)) <= 1e-6
    assert te.num_traces == je.num_traces
    for a, b in zip(hooks[0].record, hooks[1].record):
        assert (a["step"], a["commit_time"], a["grad_evals"]) == \
            (b["step"], b["commit_time"], b["grad_evals"])
        assert abs(a["w2"] - b["w2"]) <= 1e-5 * abs(b["w2"])


def test_batches_per_chain_and_batch_fn(quads, scheds):
    jq, tq = quads
    batches = np.random.default_rng(3).standard_normal((STEPS, C, D)).astype(np.float32)
    jg = lambda p, b: jq.grad(p, None) + b  # noqa: E731
    tg = lambda p, b: tq.grad(p, None) + b  # noqa: E731
    js = jsamplers.sgld("consistent", jg, gamma=0.01, sigma=0.0, tau=TAU)
    ts = samplers.sgld("consistent", tg, gamma=0.01, sigma=0.0, tau=TAU)
    want, got, _, _ = _both_engines(js, ts, scheds, per_chain_batches=True,
                                    run_kw={"batches": batches})
    assert _rel(got, want) <= 1e-6
    # batch_fn makes one batch a (commit, chain) from its own key; an int
    # seed is read as PRNGKey(seed), and a torch.Generator is refused
    e = ClusterEngine(ts, num_chains=C, chunk_size=10, collect_aux=True,
                      batch_fn=lambda k: rng.jax_normal(k, (D,)))
    st, aux = e.run(e.init(torch.zeros(D), rng.PRNGKey(2)), steps=STEPS,
                    schedule=scheds[1], key=5)
    st2, _ = e.run(e.init(torch.zeros(D), rng.PRNGKey(2)), steps=STEPS,
                   schedule=scheds[1], key=rng.PRNGKey(5))
    assert torch.equal(st.params, st2.params)
    with pytest.raises(TypeError, match="torch.Generator"):
        e.run(e.init(torch.zeros(D), rng.PRNGKey(2)), steps=STEPS,
              schedule=scheds[1], key=torch.Generator().manual_seed(5))
    # no aux from the oracle: only the schedule's commit times, (steps, C)
    assert set(aux) == {"commit_time"} and aux["commit_time"].shape == (STEPS, C)


# -- diagnostics and recorders ------------------------------------------------------------
def test_split_rhat_ess_and_w2_match_reference():
    r = np.random.default_rng(0)
    draws = (np.cumsum(r.standard_normal((6, 64, 3)), axis=1) * 0.1
             + r.standard_normal((6, 64, 3))).astype(np.float32)
    for ours, theirs in ((split_rhat, jensemble.split_rhat), (ess, jensemble.ess)):
        assert _rel(ours(torch.from_numpy(draws)), theirs(jnp.asarray(draws))) <= 1e-5
    cloud = r.standard_normal((32, 2)).astype(np.float32)
    target = r.standard_normal((48, 2)).astype(np.float32)
    assert _rel(ensemble_w2(torch.from_numpy(cloud), target),
                jensemble.ensemble_w2(jnp.asarray(cloud), jnp.asarray(target))) <= 1e-5
    a, b = cloud[:, :1], target[:32, :1]
    assert _rel(ensemble_w2(torch.from_numpy(a), b),
                jensemble.ensemble_w2(jnp.asarray(a), jnp.asarray(b))) <= 1e-5
    with pytest.raises(ValueError):
        ess(torch.zeros(1, 8, 1))


def test_recorders_rows_match_reference(quads, scheds):
    js, ts = _presets(*quads, "sgld", 0.5)
    target = np.random.default_rng(4).standard_normal((64, D)).astype(np.float32)
    tw, jw = w2_recorder(target, every=15), jensemble.w2_recorder(
        jnp.asarray(target), every=15)
    td, jd = diagnostics_recorder(every=1, window=4), jensemble.diagnostics_recorder(
        every=1, window=4)
    je = JClusterEngine(js, num_chains=C, chunk_size=5, hooks=[jw, jd])
    te = ClusterEngine(ts, num_chains=C, chunk_size=5, hooks=[tw, td])
    je.run(je.init(jnp.zeros(D), jax.random.PRNGKey(2), jitter=1.0), steps=STEPS,
           schedule=scheds[0])
    te.run(te.init(torch.zeros(D), rng.PRNGKey(2), jitter=1.0), steps=STEPS,
           schedule=scheds[1])
    assert [r["step"] for r in tw.record] == [r["step"] for r in jw.record] \
        == [5, 20, 35, 37]
    for a, b in zip(tw.record, jw.record):
        assert a["commit_time"] == b["commit_time"] and a["grad_evals"] is None
        assert abs(a["w2"] - b["w2"]) <= 1e-5 * b["w2"]
    assert [r["step"] for r in td.record] == [r["step"] for r in jd.record]
    for a, b in zip(td.record, jd.record):
        assert a["n_draws"] == b["n_draws"] == 4
        assert abs(a["rhat_max"] - b["rhat_max"]) <= 1e-5 * b["rhat_max"]
        assert abs(a["ess_min"] - b["ess_min"]) <= 1e-5 * b["ess_min"]


# -- the knobs of earlier refusals ---------------------------------------------------------
def test_refused_knobs_name_their_slice(quads, tmp_path):
    """mesh= takes a torch.distributed DeviceMesh (placement over several
    ranks: tests/test_torch_placement.py), so anything else is refused by
    name; the fault and checkpoint knobs, refused until their slice, are
    accepted, and a poison mask of the wrong shape is refused."""
    _, tq = quads
    s = samplers.sgld("consistent", lambda p, b: tq.grad(p, b), gamma=0.01,
                      sigma=0.5, tau=TAU)
    with pytest.raises(TypeError, match="mesh= takes a torch.distributed.device_mesh.DeviceMesh"):
        ClusterEngine(s, num_chains=C, mesh=object())
    e = ClusterEngine(s, num_chains=C, chunk_size=2, health_check=True)
    st, _ = e.run(e.init(torch.zeros(D), rng.PRNGKey(0)), steps=4,
                  poison=np.zeros((4, C), bool))
    assert st.health.all() and st.step == 4
    with pytest.raises(ValueError, match="poison must be"):
        e.run(e.init(torch.zeros(D), rng.PRNGKey(0)), steps=4,
              poison=np.zeros((3, C), bool))
    ck, bank = str(tmp_path / "ckpt.npz"), str(tmp_path / "bank.npz")
    e = ClusterEngine(s, num_chains=C, chunk_size=2)
    e.run(e.init(torch.zeros(D), rng.PRNGKey(0)), steps=4, checkpoint_path=ck)
    st, _ = e.resume(ck, e.init(torch.zeros(D), rng.PRNGKey(0)), steps=6)
    assert st.step == 6
    e.save_ensemble(st, bank)
    chaos = ensemble_async(WorkerModel(num_workers=4, seed=1,
                                       faults=FaultPlan(crash_rate=0.3)), 20, C)
    assert sum(sc.num_lost for sc in chaos) > 0
    st, _ = e.run(e.init(torch.zeros(D), rng.PRNGKey(0)), steps=20, schedule=chaos)
    assert st.step == 20 and torch.isfinite(st.params).all()


def test_a_commit_frees_its_read_and_gradient_without_the_garbage_collector(quads, scheds):
    """Each commit's read point and gradient are freed when the commit
    returns, not when the garbage collector next runs: at full width they
    are parameter-sized, and a reference cycle (a recursive closure in the
    tree helpers did this) held every commit's until a collection."""
    import gc
    import weakref

    _, tq = quads
    seen = []

    def grad_fn(p, b):
        g = tq.grad(p, b)
        seen.extend([weakref.ref(p), weakref.ref(g)])
        return g

    s = samplers.sgld("inconsistent", grad_fn, gamma=0.01, sigma=0.5, tau=TAU,
                      fused=True)
    engine = ClusterEngine(s, num_chains=C, chunk_size=10)
    state = engine.init(torch.zeros(D), rng.PRNGKey(0))
    was = gc.isenabled()
    gc.disable()
    try:
        engine.run(state, steps=12, schedule=scheds[1])
        assert len(seen) == 2 * 12 * C
        assert not any(r() is not None for r in seen)
    finally:
        if was:
            gc.enable()
