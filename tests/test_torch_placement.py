"""The port's placement over a device mesh — the chain axis — in gloo worlds
on the CPU, against the port's unplaced engines and the JAX package's
unsharded ones.

Two worlds are spawned once for the module (``tests/torch_placement_world.py``,
each rank a process that imports no JAX, meeting at a ``FileStore``): 2
ranks placing the chains over ``data`` 2, and 4 ranks over the JAX
package's debug mesh (``data`` 2 x ``model`` 2) for the cluster and over
``data`` 4 x ``model`` 1 for serving.  Rank 0 of each runs the unplaced
engines beside the placed ones.  They mirror the JAX package's sharded
scenarios (``tests/test_cluster.py``, ``tests/test_batch_policy.py``,
``tests/test_decode.py``, ``tests/test_paged.py``, ``tests/test_serve.py``,
without ``shard_params``, which ``tests/test_torch_model_axis.py``
covers), plus a respawn from donors on another rank, a run checkpoint
resumed, ``save_ensemble``, the prefetcher and the refusals (the model
axis' two among them).

Tolerances: placed equals unplaced bit for bit for the cluster (a commit
holds no cross-chain traffic).  For serving it is bitwise too where the
world first shows that a C/n-chain bank gives its rows of the C-chain
forward bit for bit (``rows_bitwise``); otherwise tokens are equal and
log-probs within 1e-6.  Against the JAX package the gathered results meet
the unplaced parity tests' tolerances: trajectories within 1e-6 relative
(``test_torch_cluster.py``), decode log-probs within 1e-4
(``test_torch_engines.py``), regression statistics within 1e-6 and LM
statistics within 1e-4 (``test_torch_serve.py``).  The JAX package's own
sharded serving is not an oracle (its sharded serve test fails on XLA's
CPU); its unsharded engines are.
"""

import os
import pickle
import signal
import subprocess
import sys
import time
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
from repro.cluster import PagedDecodeEngine as JPagedEngine
from repro.cluster import ServeEngine as JServeEngine
from repro.cluster import ensemble_async as jensemble_async
from repro.cluster.api import Request as JRequest
from repro.configs import get_reduced as jax_reduced
from repro.core import PolyRegression as JPolyRegression
from repro.core import Quadratic as JQuadratic
from repro.core import WorkerModel as JWorkerModel
from repro.models import regression_predict as jregression_predict
from repro.models import transformer_next_token_predict as jnext_token
from repro.models.transformer import Model as JModel
from repro.models.transformer import init_params as jax_init
from repro_torch import samplers
from repro_torch.checkpoint import save_checkpoint
from repro_torch.cluster import init_ensemble
from repro_torch.core import Quadratic
from repro_torch.kernels import rng
from repro_torch.weights import from_jax_params

HERE = Path(__file__).parent
WORLD_TIMEOUT = 300  # seconds for both worlds, spawned together
C, STEPS, D = 8, 20, 4
WORLDS = [2, 4]
IDS = ["2 ranks", "4 ranks"]
#: the mesh axis the chains are placed on, its size in each world: cluster, serving
DATA = {2: {"cluster": 2, "serve": 2}, 4: {"cluster": 2, "serve": 4}}
STAT_TOL = dict(rtol=1e-6, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jbank():
    cfg = replace(jax_reduced("qwen3-4b"), dtype="float32")
    return cfg, jax.vmap(lambda k: jax_init(k, cfg))(jax.random.split(jax.random.PRNGKey(0), C))


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Spawn both worlds, wait for them (killing every rank on timeout),
    and load what they wrote: ``{world: (rank 0's results, [each rank's
    report], log text)}``."""
    root = tmp_path_factory.mktemp("placement")
    _, jbank = _jbank()
    save_checkpoint(str(root / "bank.npz"),
                    from_jax_params(jax.tree_util.tree_map(np.asarray, jbank), device="cpu"))
    procs = {}
    for w in WORLDS:
        out = root / f"world{w}"
        out.mkdir()
        procs[w] = [subprocess.Popen(
            [sys.executable, str(HERE / "torch_placement_world.py"), str(r), str(w),
             str(root / f"store{w}"), str(out), str(root)],
            stdout=open(out / f"log{r}.txt", "w"), stderr=subprocess.STDOUT,
            start_new_session=True) for r in range(w)]
    deadline = time.monotonic() + WORLD_TIMEOUT
    timed_out = False
    try:
        for ps in procs.values():
            for p in ps:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
    loaded = {}
    for w, ps in procs.items():
        out = root / f"world{w}"
        logs = "\n".join((out / f"log{r}.txt").read_text()[-3000:] for r in range(w))
        if timed_out or any(p.returncode for p in ps):
            loaded[w] = (None, None, f"timed out: {timed_out}; exit codes "
                         f"{[p.returncode for p in ps]}\n{logs}")
            continue
        with open(out / f"world{w}.pkl", "rb") as f:
            res = pickle.load(f)
        reports = []
        for r in range(w):
            with open(out / f"world{w}_rank{r}.pkl", "rb") as f:
                reports.append(pickle.load(f))
        loaded[w] = (res, reports, logs)
    return loaded


def _world(worlds, w):
    res, reports, logs = worlds[w]
    if res is None:
        pytest.fail(f"the {w}-rank world failed:\n{logs}")
    return res, reports


def _rows_bitwise(reports, predict: str) -> bool:
    """Whether the world showed, for ``predict`` (``lm``: the model's
    prefill, ``reg``: the regression's, ``quad``: the cluster test's
    product), that a block of the bank gives its rows of the whole bank's
    forward bit for bit (``quad`` is measured on rank 0)."""
    seen = [rep["rows_bitwise"][predict] for rep in reports
            if predict in rep["rows_bitwise"]]
    return bool(seen) and all(seen)


def _same(got, want, bitwise: bool, tol=STAT_TOL):
    if bitwise:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)


# ---------------------------------------------------------------------------
# the JAX package's unsharded runs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jquad():
    return JQuadratic.make(jax.random.PRNGKey(0), d=D, m=1.0, L=3.0)


def _jsampler(jq, mode="consistent", fused=False):
    return jsamplers.sgld(mode, lambda p, b: jq.grad(p, b), gamma=0.01, sigma=0.5, tau=8,
                          fused=fused)


@pytest.fixture(scope="module")
def jax_cluster(jquad):
    """The JAX package's runs of the worlds' cluster scenarios."""
    scheds = jensemble_async(JWorkerModel(num_workers=4, seed=1), STEPS, C, seed=0)
    out = {}
    for name, mode, fused in (("sgld", "consistent", False), ("fused", "inconsistent", True)):
        e = JClusterEngine(_jsampler(jquad, mode, fused), num_chains=C, chunk_size=10)
        out[name], _ = e.run(e.init(jnp.zeros(D), jax.random.PRNGKey(42), jitter=1.0),
                             steps=STEPS, schedule=scheds)
    d, b0 = 3, 4
    q3 = JQuadratic.make(jax.random.PRNGKey(0), d=d, m=1.0, L=3.0)
    msched = jensemble_async(JWorkerModel(num_workers=4, heterogeneity=0.6, seed=1), STEPS,
                             C, seed=0, batch_policy="inverse-speed", base_batch=b0)
    tau = max(s.max_delay for s in msched)
    ms = jsamplers.sgld("consistent", lambda p, e: q3.grad(p, None) + 0.3 * e, gamma=0.01,
                        sigma=0.5, tau=max(tau, 1), base_batch=b0)
    data = jnp.asarray(np.random.default_rng(2).standard_normal((512, d)).astype(np.float32))
    e = JClusterEngine(ms, num_chains=C, chunk_size=10, batch_policy="inverse-speed")
    out["masked"], _ = e.run(e.init(jnp.zeros(d), jax.random.PRNGKey(42)), steps=STEPS,
                             schedule=msched, data=data)
    poison = np.zeros((STEPS, C), bool)
    poison[3, :C // 2] = True
    poison[12, 6] = True
    e = JClusterEngine(_jsampler(jquad, "inconsistent", True), num_chains=C, chunk_size=5,
                       health_check=True)
    out["health"], _ = e.run(e.init(jnp.zeros(D), jax.random.PRNGKey(42), jitter=1.0),
                             steps=STEPS, schedule=scheds, poison=poison)
    e = JClusterEngine(_jsampler(jquad, "inconsistent", True), num_chains=C, chunk_size=5,
                       health_check=True)
    out["resume"], _ = e.run(e.init(jnp.zeros(D), jax.random.PRNGKey(6)), steps=STEPS,
                             schedule=scheds, poison=poison)
    return out


def _jax_params(state):
    return np.asarray(getattr(state, "state", state).params)


# ---------------------------------------------------------------------------
# what needs no world: a block of chains is its rows of the whole
# ---------------------------------------------------------------------------
def test_a_block_of_a_jax_normal_draw_is_its_rows_of_the_whole():
    whole = rng.jax_normal(rng.PRNGKey(5), (8, 3, 5))
    for lo, hi in ((0, 2), (2, 6), (7, 8)):
        part = rng.jax_normal(rng.PRNGKey(5), (hi - lo, 3, 5), start=lo * 15)
        assert torch.equal(part, whole[lo:hi])


@pytest.mark.parametrize("jitter", [0.0, 1.0])
def test_an_ensemble_block_is_its_rows_of_the_whole_ensemble(jitter):
    """``init_ensemble(chains=block)`` builds chain c with its key and its
    jitter rows: the blocks, stacked, are the whole state bit for bit."""
    quad = Quadratic.make(rng.PRNGKey(0), d=D, m=1.0, L=3.0, device="cpu")
    s = samplers.sgld("inconsistent", lambda p, b: quad.grad(p, b), gamma=0.01, sigma=0.5,
                      tau=3, fused=True)
    whole = init_ensemble(s, torch.zeros(D), rng.PRNGKey(2), num_chains=C, jitter=jitter)
    parts = [init_ensemble(s, torch.zeros(D), rng.PRNGKey(2), num_chains=C, jitter=jitter,
                           chains=slice(lo, lo + 2)) for lo in range(0, C, 2)]
    assert torch.equal(torch.cat([p.params for p in parts]), whole.params)
    assert [k for p in parts for k in p.key] == whole.key
    ring = whole.inner[0]
    assert torch.equal(torch.cat([p.inner[0].history for p in parts]), ring.history)
    assert torch.equal(torch.cat([p.inner[0].head for p in parts]), ring.head)
    with pytest.raises(ValueError, match="contiguous"):
        init_ensemble(s, torch.zeros(D), rng.PRNGKey(2), num_chains=C, chains=slice(0, 8, 2))


# ---------------------------------------------------------------------------
# the cluster
# ---------------------------------------------------------------------------
CLUSTER = ["sgld", "fused", "masked", "health"]


@pytest.mark.parametrize("name", CLUSTER)
@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_placed_cluster_is_bitwise_the_unplaced_run(worlds, w, name):
    """W-Con, fused W-Icon, the masked (inverse-speed) windows and
    ``health_check`` under poisons: the gathered placed state equals the
    unplaced engine's in parameters, keys, commit counter and health."""
    res, _ = _world(worlds, w)
    got = res[f"cluster_{name}"]
    assert np.array_equal(got["params"], got["ref_params"])
    assert np.array_equal(got["key"], got["ref_key"])
    assert got["step"] == got["ref_step"] == STEPS
    if name == "health":
        assert np.array_equal(got["health"], got["ref_health"]) and got["health"].all()


@pytest.mark.parametrize("name", CLUSTER)
@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_placed_cluster_matches_the_jax_package(worlds, jax_cluster, w, name):
    res, _ = _world(worlds, w)
    got, want = res[f"cluster_{name}"], jax_cluster[name]
    assert _rel(got["params"], _jax_params(want)) <= 1e-6
    s = getattr(want, "state", want)
    assert np.array_equal(got["key"], np.asarray(s.key, np.int64))
    if name == "health":
        assert np.array_equal(got["health"], np.asarray(want.health))


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_the_masked_path_keeps_the_unplaced_layouts(worlds, w):
    """The placed masked run meets the chunk layouts (ladder rungs) the
    unplaced one meets, as the JAX package's sharded masked test asks."""
    res, _ = _world(worlds, w)
    placed, plain = res["masked_traces"]
    assert placed == plain >= 1


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_respawn_takes_donors_from_another_rank(worlds, w):
    """The poisons quarantine the whole first block of chains (and chain 6):
    the donors, round-robin over the healthy global indices, lie on another
    rank, and the respawned chains are finite and bitwise the unplaced
    run's."""
    res, _ = _world(worlds, w)
    per = C // DATA[w]["cluster"]
    poison = res["health_poison"]
    sick = np.flatnonzero(poison[3])
    donors = np.flatnonzero(~poison[3])
    donor = donors[np.arange(sick.size) % donors.size]
    assert any(a // per != b // per for a, b in zip(sick, donor))
    got = res["cluster_health"]
    assert np.isfinite(got["params"]).all()
    assert np.array_equal(got["params"], got["ref_params"])


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_a_placed_run_checkpoint_resumes_bitwise(worlds, jax_cluster, w):
    """A placed run stopped at commit 10 (its run checkpoint) and resumed to
    20 is bitwise the uninterrupted placed run, within 1e-6 of the JAX
    package's."""
    res, _ = _world(worlds, w)
    full, resumed = res["resume"]["full"], res["resume"]["resumed"]
    for k in ("params", "key", "health"):
        assert np.array_equal(full[k], resumed[k]), k
    assert full["step"] == resumed["step"] == STEPS
    want = jax_cluster["resume"]
    assert _rel(resumed["params"], _jax_params(want)) <= 1e-6
    assert np.array_equal(resumed["health"], np.asarray(want.health))


@pytest.mark.parametrize("kind", ["run_checkpoint", "save_ensemble"])
@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_placed_files_equal_the_unplaced_runs_files(worlds, w, kind):
    """The origin rank writes, from the gathered rows, the file an unplaced
    run writes: the same members, arrays and CRC manifest (so it crosses to
    the JAX package as an unplaced run's file does)."""
    res, _ = _world(worlds, w)
    placed, plain = res[kind]
    assert sorted(placed) == sorted(plain)
    for k in plain:
        assert placed[k].dtype == plain[k].dtype and np.array_equal(placed[k], plain[k]), k


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_hooks_on_a_placed_state_see_every_chain(worlds, w):
    res, _ = _world(worlds, w)
    assert res["w2_placed"] == res["w2_unplaced"] and len(res["w2_placed"]) == 2


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_from_cluster_serves_a_placed_state(worlds, w):
    res, reports = _world(worlds, w)
    for g, r in zip(res["from_cluster"], res["from_cluster_ref"]):
        _same(g, r, _rows_bitwise(reports, "quad"))


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_no_rank_holds_more_than_its_block(worlds, w):
    """Every rank's local tensors — the cluster state and its ring, the
    keys, the decode banks and caches, the page pool, the restored bank, the
    serving bank, the prefetched rows — hold its C/n chains (n the chain
    axis' size), and a replicated batch all of it."""
    _, reports = _world(worlds, w)
    for rep in reports:
        loc = rep["local"]
        for name, sizes in loc.items():
            if name.startswith("prefetch"):
                want = 8 if name.endswith("replicated") else 8 // DATA[w]["cluster"]
            elif name.startswith(("cluster", "resume")):
                want = C // DATA[w]["cluster"]
            else:
                want = C // DATA[w]["serve"]
            assert sizes == [want], (name, sizes)
        assert len(loc) == 13


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_serving():
    cfg, jbank = _jbank()
    model = JModel(cfg, remat=False)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 5)).astype(np.int32)
    dec = JDecodeEngine(model=model, params=jbank, max_seq=32, fused=True,
                        return_logits=True).generate(toks, 6)
    gen = np.random.default_rng(0)
    reqs = [(gen.integers(0, cfg.vocab_size, (t,)).astype(np.int32), n)
            for t, n in [(5, 6), (3, 4), (7, 5)]]
    eng = JPagedEngine(model=model, params=jbank, num_slots=2, page_size=8, max_seq=32,
                       decode_chunk=4, fused=True, return_logits=True)
    ids = [eng.submit(JRequest(tokens=t, max_new_tokens=n)) for t, n in reqs[:2]]
    comps = {c.request_id: c for c in eng.drain()}
    lm_toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    lm = JServeEngine(predict_fn=jnext_token(model), params=jbank, quantiles=(0.1, 0.9),
                      donate=False)({"tokens": lm_toks})
    jreg = JPolyRegression.make(jax.random.PRNGKey(0))
    rbank = jnp.asarray(np.random.default_rng(1).standard_normal((C, 5)).astype(np.float32))
    srv = JServeEngine(predict_fn=jregression_predict(jreg), params=rbank)
    qs = [np.random.default_rng(10 + i).uniform(-1, 1, n).astype(np.float32)
          for i, n in enumerate((5, 3, 16, 8))]
    return {"decode": dec, "paged": [(np.asarray(comps[i].tokens), np.asarray(comps[i].logits))
                                     for i in ids],
            "lm": lm, "serve": [srv(z) for z in qs]}


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_placed_decode_streams_the_unplaced_tokens(worlds, w):
    res, reports = _world(worlds, w)
    got, want = res["decode"], res["decode_ref"]
    assert np.array_equal(got["tokens"], want["tokens"])
    assert np.array_equal(got["sampled"], want["sampled"])
    _same(got["logits"], want["logits"], _rows_bitwise(reports, "lm"))
    restored = res["decode_restored"]
    assert np.array_equal(restored["tokens"], got["tokens"])
    assert np.array_equal(restored["logits"], got["logits"])


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_placed_decode_matches_the_jax_package(worlds, jax_serving, w):
    res, _ = _world(worlds, w)
    want = jax_serving["decode"]
    np.testing.assert_array_equal(res["decode"]["tokens"], np.asarray(want.tokens))
    np.testing.assert_allclose(res["decode"]["logits"], np.asarray(want.logits), **LOGIT_TOL)


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_placed_paged_decode_equals_the_unplaced_engine(worlds, w):
    """Three requests over two slots (one waits for a slot, one samples,
    one carries a deadline judged on the mesh's first rank)."""
    res, reports = _world(worlds, w)
    for (gt, gl), (wt, wl) in zip(res["paged"], res["paged_ref"]):
        assert np.array_equal(gt, wt)
        _same(gl, wl, _rows_bitwise(reports, "lm"))


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_placed_paged_decode_matches_the_jax_package(worlds, jax_serving, w):
    """The greedy requests (the port's sampled tokens are not JAX's by
    design)."""
    res, _ = _world(worlds, w)
    for (gt, gl), (wt, wl) in zip(res["paged"], jax_serving["paged"]):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_allclose(gl, wl, **LOGIT_TOL)


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_placed_serving_equals_the_unplaced_engine(worlds, w):
    """The regression bank over four query batches (three bucket rungs),
    and the LM bank's next-token statistics."""
    res, reports = _world(worlds, w)
    for got, want in zip(res["serve"], res["serve_ref"]):
        for g, r in zip(got, want):
            _same(g, r, _rows_bitwise(reports, "reg"))
    assert res["serve_traces"] == 3
    for g, r in zip(res["lm_serve"], res["lm_serve_ref"]):
        _same(g, r, _rows_bitwise(reports, "lm"))


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_placed_serving_matches_the_jax_package(worlds, jax_serving, w):
    res, _ = _world(worlds, w)
    for got, want in zip(res["serve"], jax_serving["serve"]):
        for g, r in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(r), **STAT_TOL)
    for g, r in zip(res["lm_serve"], jax_serving["lm"]):
        np.testing.assert_allclose(g, np.asarray(r), **LOGIT_TOL)


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_the_decoder_of_a_placed_serve_engine_is_placed(worlds, w):
    res, _ = _world(worlds, w)
    assert res["decoder_placed"]
    assert np.array_equal(res["decoder"], res["decoder_ref"])


# ---------------------------------------------------------------------------
# the prefetcher, the mesh helpers, the refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_the_prefetcher_keeps_its_rows(worlds, w):
    """Every rank makes the reference's key sequence and keeps its rows over
    ``data`` (replicated over the other axes; a 0-d leaf replicated), with
    no collective: gathered, the batches are the unplaced prefetcher's."""
    res, _ = _world(worlds, w)
    pf = res["prefetch"]
    for axes in (("data",), ()):
        for got, want in zip(pf[axes], pf["unplaced"]):
            for k in want:
                assert np.array_equal(got[k], want[k]), (axes, k)
    assert all("Shard(dim=0)" in p for p in pf[(("data",), "placements")])
    assert all("Shard" not in p for p in pf[((), "placements")])
    assert all(x.shape == (4, 3) for x in pf[(("data",), "local")])


@pytest.mark.parametrize("w", WORLDS, ids=IDS)
def test_mesh_axes_of_a_device_mesh(worlds, w):
    res, _ = _world(worlds, w)
    pf = res["prefetch"]
    assert pf["batch_axes_for"] == (("data",), ())  # 8 divides over data 2, 3 does not
    assert pf["fsdp_axes_for"] == ("data",)


REFUSALS = {
    "dtensor_op": ("TypeError", "delay_gather takes a rank's local tensors"),
    "dtensor_update": ("TypeError", "fused_langevin_update takes a rank's local tensors"),
    "experts_not_dividing": ("ValueError", "3 experts do not divide over the 'model' axis"),
    "straddling_group": ("ValueError", "straddles a group"),
    "not_dividing": ("ValueError", "num_chains=3 must be divisible by mesh axis 'data'"),
    "no_chain_axis": ("ValueError", "no axis 'pod'"),
    "not_a_mesh": ("TypeError", "DeviceMesh"),
    "bank_not_dividing": ("ValueError", "num_chains=3 must be divisible"),
    "mesh_too_big": ("RuntimeError", "need 16 devices, have 2"),
    "production_mesh": ("RuntimeError", "need 256 devices, have 2"),
}


def test_a_mesh_smaller_than_the_world_keeps_its_collectives(worlds):
    """A mesh over ranks 0 and 1 of the 4-rank world: the placed run
    checkpoint (its write waits at a barrier of the mesh's ranks) resumes
    bitwise the unplaced uninterrupted run, and the placed paged engine
    (its deadline broadcast over the mesh) streams the unplaced tokens,
    while ranks 2 and 3 have left the scenario."""
    res, _ = _world(worlds, 4)
    got = res["submesh"]
    assert np.array_equal(got["resumed"]["params"], got["full_ref"])
    assert got["resumed"]["step"] == 10 and got["resumed"]["health"].all()
    for (gt, gl), (wt, wl) in zip(got["paged"], got["paged_ref"]):
        assert np.array_equal(gt, wt)
        _same(gl, wl, bitwise=False)


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_name_what_they_refuse(worlds, name):
    res, _ = _world(worlds, 2)
    kind, text = REFUSALS[name]
    got = res["refusals"][name]
    assert got is not None and got[0] == kind and text in got[1], got


def test_a_placed_state_with_quarantined_chains_serves_degraded(worlds):
    """A placed 4-chain bank with one quarantined chain on each rank of the
    2-rank world: the survivors gathered and placed again over ``data`` (a
    chain a rank) stream the unplaced degraded engine's tokens, log-probs
    within 1e-5, and the gauge counts the two; with one quarantined the 3
    survivors do not divide over 2 ranks and are refused with the
    reference's message."""
    res, _ = _world(worlds, 2)
    got, want = res["degraded"], res["degraded_ref"]
    assert got["num_chains"] == 2 and got["mesh"] and got["local"] == [1]
    assert got["unhealthy"] == 2.0
    assert np.array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5, atol=1e-5)
    assert res["degraded_refusal"] == ("num_chains=3 must be divisible by mesh axis "
                                       "'data' (size 2)")
