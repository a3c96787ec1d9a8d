"""Faults and self-healing of repro_torch's ClusterEngine against the JAX
package's, on the CPU, at the JAX fault tests' sizes (C 8 chains, a d=4
``Quadratic``, tau 8, or 32 where chaos schedules rejoin staler).

Tolerances, as ``tests/test_torch_cluster.py`` states them: trajectories
agree within 1e-6 relative to their largest coordinate where both draw
the same noise bits (the unfused ``noise="jax"`` draw; the fused preset's
threefry noise), only float32 rounding apart; health masks, keys, ring
heads, commit counters, respawn counts and schedules are equal exactly.
Inside the port, a resumed run is bitwise the uninterrupted one.

One difference by design is pinned here: a chain that goes non-finite in
a commit has its ring head rolled back, but the slot its push overwrote
keeps the pushed iterate (the JAX package keeps the whole ring); the chain
reads its ring no more until a respawn replaces it.
"""

import os
import signal
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import samplers as jsamplers
from repro.cluster import ClusterEngine as JClusterEngine
from repro.cluster import DecodeEngine as JDecodeEngine
from repro.cluster import HealthState as JHealthState
from repro.cluster import diagnostics_recorder as jdiagnostics
from repro.cluster import ensemble_async as jensemble_async
from repro.cluster import w2_recorder as jw2
from repro.cluster.schedule import WorkerSchedule as JWorkerSchedule
from repro.configs import get_reduced as jax_reduced
from repro.core import FaultPlan as JFaultPlan
from repro.core import Quadratic as JQuadratic
from repro.core import WorkerModel as JWorkerModel
from repro.faults import nan_storm as jnan_storm
from repro.models.transformer import Model as JModel
from repro.models.transformer import init_params as jax_init
from repro.obs.metrics import registry as jregistry
from repro.samplers.base import SamplerState as JSamplerState
from repro_torch import samplers
from repro_torch.checkpoint import CorruptCheckpointError, checkpoint_step
from repro_torch.cluster import (
    ClusterEngine,
    DecodeEngine,
    PagedDecodeEngine,
    WorkerSchedule,
    diagnostics_recorder,
    ensemble_async,
    healthy_chains,
    w2_recorder,
)
from repro_torch.configs import get_reduced
from repro_torch.core import FaultPlan, Quadratic, WorkerModel
from repro_torch.core.delay import heads
from repro_torch.faults import HealthState, nan_storm
from repro_torch.kernels import rng
from repro_torch.obs.metrics import registry
from repro_torch.samplers.base import SamplerState
from repro_torch.utils import tree_map
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

SRC = str(Path(__file__).resolve().parent.parent / "src")
C, STEPS, TAU, D = 8, 37, 8, 4
CHAOS = dict(crash_rate=0.15, mean_downtime=2.0, pause_rate=0.1, mean_pause=1.0)


@pytest.fixture(scope="module")
def quads():
    return (JQuadratic.make(jax.random.PRNGKey(0), d=D, m=1.0, L=3.0),
            Quadratic.make(rng.PRNGKey(0), d=D, m=1.0, L=3.0, device="cpu"))


def _pair(quads, mode="consistent", tau=TAU, fused=False):
    jq, tq = quads
    return (jsamplers.sgld(mode, lambda p, b: jq.grad(p, b), gamma=0.01, sigma=0.5,
                           tau=tau, fused=fused),
            samplers.sgld(mode, lambda p, b: tq.grad(p, b), gamma=0.01, sigma=0.5,
                          tau=tau, fused=fused, noise="jax"))


def _chaos(steps, chains=C, seed=0):
    return (jensemble_async(JWorkerModel(num_workers=4, seed=1, faults=JFaultPlan(**CHAOS)),
                            steps, chains, seed=seed),
            ensemble_async(WorkerModel(num_workers=4, seed=1, faults=FaultPlan(**CHAOS)),
                           steps, chains, seed=seed))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _keys(jkeys):
    return [tuple(int(v) for v in k) for k in np.asarray(jkeys)]


def _count(reg, name):
    return reg.snapshot().get(name, {}).get("value", 0.0)


def _assert_bitwise(a, b):
    """Two port carries equal leaf for leaf, the health mask included."""
    if isinstance(a, HealthState):
        assert np.array_equal(a.health, b.health)
        a, b = a.state, b.state
    assert a.step == b.step and a.key == b.key
    assert torch.equal(a.params, b.params)
    ra, rb = a.inner[0], b.inner[0]
    assert torch.equal(ra.history, rb.history) and torch.equal(ra.head, rb.head)


# -- chaos schedules -------------------------------------------------------------------
def test_zero_rate_fault_plan_is_bitwise_no_plan(quads):
    """An inert plan realises the schedules of no plan, and the engine runs
    them bitwise as it runs no plan (no liveness input)."""
    _, ts = _pair(quads)
    plain = ensemble_async(WorkerModel(num_workers=4, seed=2), 30, C, seed=5)
    inert = ensemble_async(WorkerModel(num_workers=4, seed=2, faults=FaultPlan()),
                           30, C, seed=5)
    assert all(s.alive is None for s in inert) and not FaultPlan().active
    outs = []
    for sched in (plain, inert):
        e = ClusterEngine(ts, num_chains=C, chunk_size=10)
        outs.append(e.run(e.init(torch.zeros(D), rng.PRNGKey(4)), steps=30,
                          schedule=sched)[0])
    _assert_bitwise(*outs)


def test_dead_commits_freeze_iterate_ring_and_head_yet_use_their_version_slots(quads):
    """A chain whose every commit is lost keeps its start, its ring rows and
    its head bit for bit while its commit counter reaches 30; the live chain
    moves as the JAX package's does."""
    js, ts = _pair(quads)
    reads, wid = np.arange(STEPS), np.zeros(STEPS, np.int64)
    times = np.arange(STEPS, dtype=np.float64)
    scheds = [[cls(read_versions=reads, worker_ids=wid, commit_times=times,
                   num_workers=1, alive=alive)
               for alive in (np.zeros(STEPS, bool), None)]
              for cls in (JWorkerSchedule, WorkerSchedule)]
    je = JClusterEngine(js, num_chains=2, chunk_size=10)
    te = ClusterEngine(ts, num_chains=2, chunk_size=10)
    jout, _ = je.run(je.init(jnp.ones(D), jax.random.PRNGKey(0)), steps=30,
                     schedule=scheds[0])
    st = te.init(torch.ones(D), rng.PRNGKey(0))
    ring0 = st.inner[0].history.clone()
    out, _ = te.run(st, steps=30, schedule=scheds[1])
    assert torch.equal(out.params[0], torch.ones(D))
    assert not torch.equal(out.params[1], torch.ones(D))
    assert torch.equal(out.inner[0].history[0], ring0[0])
    assert heads(out.inner[0]) == np.asarray(jout.inner[0].head).tolist() == [0, 30 % 9]
    assert out.step == 30 and (np.asarray(jout.step) == 30).all()
    assert _rel(out.params, jout.params) <= 1e-6
    assert _rel(out.inner[0].history, jout.inner[0].history) <= 1e-6
    assert out.key == _keys(jout.key)
    assert te.num_traces == je.num_traces == 1


@pytest.mark.parametrize("mode,fused", [("consistent", False), ("inconsistent", True)],
                         ids=["wcon", "wicon-fused"])
def test_health_check_without_faults_is_bitwise_the_unchecked_run(quads, mode, fused):
    js, ts = _pair(quads, mode, fused=fused)
    jsched, tsched = (f(M(num_workers=4, seed=1), 30, C, seed=0) for f, M in
                      ((jensemble_async, JWorkerModel), (ensemble_async, WorkerModel)))
    plain = ClusterEngine(ts, num_chains=C, chunk_size=10)
    want, _ = plain.run(plain.init(torch.zeros(D), rng.PRNGKey(42)), steps=30,
                        schedule=tsched)
    guarded = ClusterEngine(ts, num_chains=C, chunk_size=10, health_check=True)
    out, _ = guarded.run(guarded.init(torch.zeros(D), rng.PRNGKey(42)), steps=30,
                         schedule=tsched)
    assert isinstance(out, HealthState) and out.health.all()
    _assert_bitwise(out.state, want)
    je = JClusterEngine(js, num_chains=C, chunk_size=10, health_check=True)
    jout, _ = je.run(je.init(jnp.zeros(D), jax.random.PRNGKey(42)), steps=30,
                     schedule=jsched)
    assert _rel(out.params, jout.params) <= 1e-6 and out.key == _keys(jout.key)
    assert guarded.num_traces == 1


def test_chaos_run_matches_reference_and_stays_finite(quads):
    js, ts = _pair(quads, tau=32)
    jsched, tsched = _chaos(60)
    assert sum(s.num_lost for s in tsched) > 0
    je = JClusterEngine(js, num_chains=C, chunk_size=10, health_check=True)
    te = ClusterEngine(ts, num_chains=C, chunk_size=10, health_check=True)
    jout, _ = je.run(je.init(jnp.zeros(D), jax.random.PRNGKey(3)), steps=60,
                     schedule=jsched)
    out, _ = te.run(te.init(torch.zeros(D), rng.PRNGKey(3)), steps=60, schedule=tsched)
    assert torch.isfinite(out.params).all() and out.step == 60
    assert _rel(out.params, jout.params) <= 1e-6 and out.key == _keys(jout.key)
    assert heads(out.inner[0]) == np.asarray(jout.inner[0].head).tolist()
    assert np.array_equal(out.health, np.asarray(jout.health))
    assert te.num_traces == 1


# -- quarantine and respawn -------------------------------------------------------------
POISON = np.zeros((30, C), bool)
POISON[5, 2] = POISON[5, 5] = True


@pytest.mark.parametrize("mode,fused", [("consistent", False), ("inconsistent", True),
                                        ("sync", True)],
                         ids=["wcon", "wicon-fused", "sync-fused"])
def test_poison_quarantines_then_respawns(quads, mode, fused):
    """Out of place (W-Con), in place from the ring slot (fused W-Icon), in
    place from a copy (fused Sync, no ring): the poisoned chains are
    quarantined, restored, respawned at the boundary from donors 0 and 1
    with fresh keys, as in the JAX package."""
    js, ts = _pair(quads, mode, tau=0 if mode == "sync" else TAU, fused=fused)
    jreg, reg = jregistry(), registry()
    j0 = (_count(jreg, "chains.quarantined"), _count(jreg, "chains.respawned"))
    t0 = (_count(reg, "chains.quarantined"), _count(reg, "chains.respawned"),
          _count(reg, "faults.injected"))
    je = JClusterEngine(js, num_chains=C, chunk_size=10, health_check=True)
    te = ClusterEngine(ts, num_chains=C, chunk_size=10, health_check=True)
    jout, _ = je.run(je.init(jnp.zeros(D), jax.random.PRNGKey(1)), steps=30,
                     poison=POISON)
    out, _ = te.run(te.init(torch.zeros(D), rng.PRNGKey(1)), steps=30, poison=POISON)
    assert out.health.all() and np.asarray(jout.health).all()
    assert torch.isfinite(out.params).all()
    assert not torch.equal(out.params[2], out.params[0])  # a fresh key: decorrelated
    assert _rel(out.params, jout.params) <= 1e-6 and out.key == _keys(jout.key)
    jd = (_count(jreg, "chains.quarantined") - j0[0], _count(jreg, "chains.respawned") - j0[1])
    td = (_count(reg, "chains.quarantined") - t0[0], _count(reg, "chains.respawned") - t0[1])
    assert td == jd == (2.0, 2.0)
    assert _count(reg, "faults.injected") - t0[2] == 2.0


def test_quarantine_without_respawn_is_sticky(quads):
    js, ts = _pair(quads)
    je = JClusterEngine(js, num_chains=C, chunk_size=10, health_check=True, respawn=False)
    te = ClusterEngine(ts, num_chains=C, chunk_size=10, health_check=True, respawn=False)
    jout, _ = je.run(je.init(jnp.zeros(D), jax.random.PRNGKey(1)), steps=30,
                     poison=POISON)
    out, _ = te.run(te.init(torch.zeros(D), rng.PRNGKey(1)), steps=30, poison=POISON)
    assert np.array_equal(out.health, np.asarray(jout.health))
    assert not out.health[2] and not out.health[5] and out.health.sum() == C - 2
    assert torch.isfinite(out.params).all()  # frozen at the last healthy iterate
    assert _rel(out.params, jout.params) <= 1e-6 and out.key == _keys(jout.key)
    assert heads(out.inner[0]) == np.asarray(jout.inner[0].head).tolist()


@pytest.mark.parametrize("fused", [False, True], ids=["wcon", "wicon-fused"])
def test_quarantined_ring_keeps_its_head_not_the_slot_its_push_overwrote(quads, fused):
    """The difference by design: chain 2, poisoned at commit 5, had X_5
    pushed into slot 6 before its commit; its head rolls back to 5, and
    slot 6 keeps X_5 where the JAX ring keeps X_0.  Every other ring row
    and slot agrees with the JAX package's."""
    js, ts = _pair(quads, "inconsistent" if fused else "consistent", fused=fused)
    je = JClusterEngine(js, num_chains=C, chunk_size=10, health_check=True, respawn=False)
    te = ClusterEngine(ts, num_chains=C, chunk_size=10, health_check=True, respawn=False)
    jout, _ = je.run(je.init(jnp.zeros(D), jax.random.PRNGKey(1)), steps=30,
                     poison=POISON)
    out, _ = te.run(te.init(torch.zeros(D), rng.PRNGKey(1)), steps=30, poison=POISON)
    jh, th = np.asarray(jout.inner[0].history), out.inner[0].history.numpy()
    assert heads(out.inner[0])[2] == int(np.asarray(jout.inner[0].head)[2]) == 5
    assert np.array_equal(th[2, 6], out.params[2].numpy())  # X_5, the frozen iterate
    assert np.array_equal(jh[2, 6], np.zeros(D, np.float32))  # X_0
    mask = np.ones(th.shape[:2], bool)
    mask[2, 6] = mask[5, 6] = False
    assert _rel(th[mask], jh[mask]) <= 1e-6


def test_recorders_mask_unhealthy_chains(quads):
    js, ts = _pair(quads)
    target = np.array(jax.random.normal(jax.random.PRNGKey(9), (256, D)))
    poison = np.zeros((40, C), bool)
    poison[3, 1] = True
    hooks = ((jw2(jnp.asarray(target), every=5), jdiagnostics(every=1, window=8)),
             (w2_recorder(target, every=5), diagnostics_recorder(every=1, window=8)))
    je = JClusterEngine(js, num_chains=C, chunk_size=5, health_check=True,
                        respawn=False, hooks=list(hooks[0]))
    te = ClusterEngine(ts, num_chains=C, chunk_size=5, health_check=True,
                       respawn=False, hooks=list(hooks[1]))
    je.run(je.init(jnp.zeros(D), jax.random.PRNGKey(1)), steps=40, poison=poison)
    out, _ = te.run(te.init(torch.zeros(D), rng.PRNGKey(1)), steps=40, poison=poison)
    assert not out.health[1]
    (jw, jd), (tw, td) = hooks
    assert [r["step"] for r in tw.record] == [r["step"] for r in jw.record] != []
    assert all(np.isfinite(r["w2"]) for r in tw.record)
    for a, b in zip(tw.record, jw.record):
        assert abs(a["w2"] - b["w2"]) <= 1e-5 * b["w2"]
    assert [r["step"] for r in td.record] == [r["step"] for r in jd.record] != []
    for a, b in zip(td.record, jd.record):
        assert abs(a["rhat_max"] - b["rhat_max"]) <= 1e-5 * b["rhat_max"]
        assert abs(a["ess_min"] - b["ess_min"]) <= 1e-5 * b["ess_min"]
    mask = healthy_chains(out.params, out)
    assert not mask[1] and mask.sum() == C - 1


def test_degraded_serving_drops_quarantined_chains():
    """``from_cluster`` of a partly quarantined model ensemble (leaves
    ``(C, 1, ...)``: each chain a bank of one, as a ClusterEngine state of
    the model holds it; chain 1 NaN and quarantined) serves the three healthy
    chains: the JAX engine's greedy tokens, log-probs within 1e-4; an
    all-quarantined state raises."""
    jcfg = replace(jax_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    jbank = jax.vmap(lambda k: jax_init(k, jcfg))(jax.random.split(jax.random.PRNGKey(0), 4))
    jbad = jax.tree_util.tree_map(lambda x: x.at[1].set(jnp.nan), jbank)
    health = np.array([True, False, True, True])
    jhs = JHealthState(JSamplerState(jbad, jnp.zeros(4, jnp.int32),
                                     jax.random.split(jax.random.PRNGKey(1), 4), ()),
                       jnp.asarray(health))
    tbank = from_jax_params(jax.tree_util.tree_map(np.asarray, jbad), device="cpu")
    ths = HealthState(SamplerState(tree_map(lambda t: t[:, None], tbank), 0,
                                   rng.split((0, 1), 4), ()), health)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    want = JDecodeEngine.from_cluster(jhs, JModel(jcfg, remat=False), max_seq=32,
                                      fused=True, return_logits=True).generate(toks, 4)
    eng = DecodeEngine.from_cluster(ths, tcfg, max_seq=32, return_logits=True,
                                    device="cpu")
    assert eng.num_chains == 3
    got = eng.generate(toks, 4)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits, np.asarray(want.logits), rtol=1e-4, atol=1e-4)
    paged = PagedDecodeEngine.from_cluster(ths, model=tcfg, num_slots=2, page_size=8,
                                           max_seq=32, device="cpu")
    assert paged.num_chains == 3
    with pytest.raises(ValueError, match="every chain is quarantined"):
        DecodeEngine.from_cluster(HealthState(ths.state, np.zeros(4, bool)), tcfg,
                                  device="cpu")


# -- checkpoints and resume ---------------------------------------------------------------
def test_resume_stitches_bitwise(quads, tmp_path):
    """A chaos run under a NaN storm, stopped at commit 20 and resumed to
    40, is bitwise the uninterrupted run; both match the JAX package's."""
    js, ts = _pair(quads, tau=32)
    jsched, tsched = _chaos(40)
    poison = nan_storm(40, C, rate=0.01, seed=7)
    assert np.array_equal(poison, jnan_storm(40, C, rate=0.01, seed=7)) and poison.any()

    def engine():
        return ClusterEngine(ts, num_chains=C, chunk_size=10, health_check=True)

    def start():
        return engine().init(torch.zeros(D), rng.PRNGKey(6))

    full, _ = engine().run(start(), steps=40, schedule=tsched, poison=poison)
    ck = str(tmp_path / "run.npz")
    engine().run(start(), steps=20, schedule=tsched, poison=poison[:20], checkpoint_path=ck)
    assert checkpoint_step(ck) == 20
    out, _ = engine().resume(ck, start(), steps=40, schedule=tsched, poison=poison)
    _assert_bitwise(out, full)
    je = JClusterEngine(js, num_chains=C, chunk_size=10, health_check=True)
    jout, _ = je.run(je.init(jnp.zeros(D), jax.random.PRNGKey(6)), steps=40,
                     schedule=jsched, poison=poison)
    assert _rel(out.params, jout.params) <= 1e-6 and out.key == _keys(jout.key)
    assert np.array_equal(out.health, np.asarray(jout.health))


def test_resume_with_missing_file_starts_fresh(quads, tmp_path):
    _, ts = _pair(quads)
    ck = str(tmp_path / "never_written.npz")
    e = ClusterEngine(ts, num_chains=C, chunk_size=10)
    out, _ = e.resume(ck, e.init(torch.zeros(D), rng.PRNGKey(0)), steps=20)
    assert out.step == 20 and os.path.exists(ck) and checkpoint_step(ck) == 20


def test_corrupt_checkpoint_raises_loudly(quads, tmp_path):
    _, ts = _pair(quads)
    ck = tmp_path / "ck.npz"
    e = ClusterEngine(ts, num_chains=C, chunk_size=10)
    e.run(e.init(torch.zeros(D), rng.PRNGKey(0)), steps=20, checkpoint_path=str(ck))
    blob = ck.read_bytes()
    (tmp_path / "trunc.npz").write_bytes(blob[:len(blob) // 2])
    flipped = bytearray(blob)
    flipped[len(flipped) // 2] ^= 0xFF
    (tmp_path / "flip.npz").write_bytes(bytes(flipped))
    for bad in ("trunc.npz", "flip.npz"):
        with pytest.raises(CorruptCheckpointError):
            e.resume(str(tmp_path / bad), e.init(torch.zeros(D), rng.PRNGKey(0)), steps=40)


_KILL_SCRIPT = r"""
import os, signal, sys
sys.modules["jax"] = None  # the port imports no JAX: importing it would fail
sys.path.insert(0, SRC)
import torch
from repro_torch import samplers
from repro_torch.cluster import ClusterEngine
from repro_torch.core import Quadratic
from repro_torch.kernels import rng

quad = Quadratic.make(rng.PRNGKey(0), d=4, m=1.0, L=3.0, device="cpu")
sampler = samplers.sgld("consistent", lambda p, b: quad.grad(p, b), gamma=0.01,
                        sigma=0.5, tau=8)
kills = [3]

def killer(done, state, aux):
    kills[0] -= 1
    if kills[0] == 0:
        os.kill(os.getpid(), signal.SIGKILL)  # no atexit, no cleanup

engine = ClusterEngine(sampler, num_chains=8, chunk_size=10, health_check=True,
                       hooks=[killer])
engine.run(engine.init(torch.zeros(4), rng.PRNGKey(6)), steps=60, checkpoint_path=CKPT)
"""


def test_resume_after_sigkill_is_bitwise(quads, tmp_path):
    """Kill -9 in the third chunk's hooks (after the second chunk's
    checkpoint), in a process that imports no JAX, then resume: the
    stitched run equals the uninterrupted one bit for bit."""
    ck = str(tmp_path / "killed.npz")
    proc = subprocess.run([sys.executable, "-c", f"CKPT = {ck!r}\nSRC = {SRC!r}\n"
                           + _KILL_SCRIPT], capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert checkpoint_step(ck) == 20
    _, tq = quads
    s = samplers.sgld("consistent", lambda p, b: tq.grad(p, b), gamma=0.01, sigma=0.5,
                      tau=8)
    e = ClusterEngine(s, num_chains=C, chunk_size=10, health_check=True)
    full, _ = e.run(e.init(torch.zeros(D), rng.PRNGKey(6)), steps=60)
    out, _ = e.resume(ck, e.init(torch.zeros(D), rng.PRNGKey(6)), steps=60)
    _assert_bitwise(out, full)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_run_checkpoints_cross_between_the_packages(quads, tmp_path, writer):
    """A run checkpoint written by one package at commit 20 (chaos, a NaN
    storm, health_check) is resumed by the other to 40, and matches the
    writer's uninterrupted run within the tolerance."""
    js, ts = _pair(quads, tau=32)
    jsched, tsched = _chaos(40)
    poison = nan_storm(40, C, rate=0.02, seed=3)
    ck = str(tmp_path / "run.npz")
    je = JClusterEngine(js, num_chains=C, chunk_size=10, health_check=True)
    te = ClusterEngine(ts, num_chains=C, chunk_size=10, health_check=True)
    jstart = lambda: je.init(jnp.zeros(D), jax.random.PRNGKey(6))  # noqa: E731
    tstart = lambda: te.init(torch.zeros(D), rng.PRNGKey(6))  # noqa: E731
    if writer == "jax":
        je.run(jstart(), steps=20, schedule=jsched, poison=poison[:20], checkpoint_path=ck)
        out, _ = te.resume(ck, tstart(), steps=40, schedule=tsched, poison=poison)
        want, _ = je.run(jstart(), steps=40, schedule=jsched, poison=poison)
        got = out
    else:
        te.run(tstart(), steps=20, schedule=tsched, poison=poison[:20], checkpoint_path=ck)
        got, _ = je.resume(ck, jstart(), steps=40, schedule=jsched, poison=poison)
        want, _ = te.run(tstart(), steps=40, schedule=tsched, poison=poison)
    g = lambda x: np.asarray(x.numpy() if torch.is_tensor(x) else x)  # noqa: E731
    assert _rel(g(got.params), g(want.params)) <= 1e-6
    assert np.array_equal(np.asarray(got.health), np.asarray(want.health))
    assert _keys(got.key) == _keys(want.key)
