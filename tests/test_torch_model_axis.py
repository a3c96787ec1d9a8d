"""The port's model axis for serving — 2-D banks (chains x tensor-parallel)
in ``DecodeEngine`` and ``PagedDecodeEngine``, head-sharded attention and
expert-parallel MoE — in gloo worlds on the CPU, against the JAX package's
unsharded engines, the port's unplaced ones and the reference's
``partition_tree`` specs.

Two worlds are spawned once for the module (``tests/torch_model_axis_world.py``,
each rank a process that imports no JAX, meeting at a ``FileStore``): 2
ranks serving over ``data`` 1 x ``model`` 2, and 4 ranks over ``data`` 2 x
``model`` 2 and over ``data`` 1 x ``model`` 4, which also run the MoE block
over ``data`` 2 x ``model`` 2.  The cases cover the layouts of the reduced
configs: qwen3-4b's 4 query heads over 2 KV heads (at ``model`` 2 each
rank its KV head; at ``model`` 4 K/V is replicated and a rank's one query
head reads one KV head, a group of 1), kimi-k2's 4 experts and a shared
expert (``fsdp_tp``: its experts' ``data`` entries are replicated, since
``data`` holds the chains), 6 query heads that ``model`` 4 does not divide
(the attention replicated), a vocabulary of 511 that neither axis divides
(embedding and head replicated), and the head-sharded layout
(``opt_attn_head_shard``: K/V replicated, each rank the KV heads its
queries read).

Tolerances, in float32: tokens equal and log-probs within 1e-4 of the JAX
package's unsharded engines (the unplaced parity tests' tolerance,
``test_torch_engines.py``); within 1e-5 of the port's unplaced engine (a
row-parallel all-reduce sums partials in another order: not bit for bit,
by design).  The JAX package's own sharded serving is no oracle (its
sharded decode and paged tests fail on XLA's CPU).
"""

import os
import pickle
import signal
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import torch_model_axis_world as world
from repro.cluster import DecodeEngine as JDecodeEngine
from repro.cluster import PagedDecodeEngine as JPagedEngine
from repro.cluster.api import Request as JRequest
from repro.configs import get_reduced as jax_reduced
from repro.launch.steps import sanitize_spec as jax_sanitize
from repro.models.common import partition_tree as jax_partition_tree
from repro.models.transformer import Model as JModel
from repro.models.transformer import init_params as jax_init
from repro_torch.checkpoint import save_checkpoint
from repro_torch.weights import from_jax_params
from subproc import run_json

HERE = Path(__file__).parent
WORLD_TIMEOUT = 300  # seconds for both worlds, spawned together
WORLDS = [2, 4]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PLACED_TOL = dict(rtol=1e-5, atol=1e-5)
#: every (world, mesh shape, case) the worlds serve
SERVED = [(w, shape, case) for w in WORLDS for shape, cases in world.MESHES[w]
          for case in cases]
SERVED_IDS = [f"{w} ranks-{shape[0]}x{shape[1]}-{case}" for w, shape, case in SERVED]


def _jcfg(case):
    return world.config(case, jax_reduced)


def _jbank(case):
    cfg = _jcfg(case)
    n = world.CASES[case][2]
    return cfg, jax.vmap(lambda k: jax_init(k, cfg))(jax.random.split(jax.random.PRNGKey(0), n))


MOE_B, MOE_S = 4, 16


def _moe_inputs():
    """The MoE block's inputs, from a numpy seed: phi3.5-moe reduced (4
    experts, top 2) with one shared expert, f32, a batch of 4 x 16."""
    cfg = replace(jax_reduced("phi3.5-moe-42b-a6.6b"), dtype="float32",
                  num_shared_experts=1)
    g = np.random.default_rng(3)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def w(*s):
        return (g.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)

    arrs = {"router": w(d, E), "w_gate": w(E, d, f), "w_up": w(E, d, f),
            "w_down": w(E, f, d), "shared_w_gate": w(d, f), "shared_w_up": w(d, f),
            "shared_w_down": w(f, d),
            "x": g.standard_normal((MOE_B, MOE_S, d)).astype(np.float32)}
    return cfg, arrs


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Spawn both worlds, wait for them (killing every rank on timeout),
    and load each rank's results: ``{world: ([each rank's], log text)}``."""
    root = tmp_path_factory.mktemp("model_axis")
    for case in world.CASES:
        _, jbank = _jbank(case)
        save_checkpoint(str(root / f"{case}.npz"),
                        from_jax_params(jax.tree_util.tree_map(np.asarray, jbank),
                                        device="cpu"))
    _, arrs = _moe_inputs()
    np.savez(root / "moe.npz", shared=1, **arrs)
    procs = {}
    for w in WORLDS:
        out = root / f"world{w}"
        out.mkdir()
        procs[w] = [subprocess.Popen(
            [sys.executable, str(HERE / "torch_model_axis_world.py"), str(r), str(w),
             str(root / f"store{w}"), str(out), str(root)],
            stdout=open(out / f"log{r}.txt", "w"), stderr=subprocess.STDOUT,
            start_new_session=True) for r in range(w)]
    _JAX.update(_jax_serving())  # while the worlds run
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
            loaded[w] = (None, f"timed out: {timed_out}; exit codes "
                         f"{[p.returncode for p in ps]}\n{logs}")
            continue
        ranks = []
        for r in range(w):
            with open(out / f"world{w}_rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        loaded[w] = (ranks, logs)
    return loaded


def _ranks(worlds, w):
    ranks, logs = worlds[w]
    if ranks is None:
        pytest.fail(f"the {w}-rank world failed:\n{logs}")
    return ranks


_JAX: dict = {}  # the JAX package's serving results, made while the worlds run


@pytest.fixture(scope="module")
def jax_serving(worlds):
    return _JAX


def _jax_serving() -> dict:
    """The JAX package's unsharded engines on each case's bank: the decode
    request and the paged requests (greedy; the sampled one is skipped,
    the port's sampled tokens are not JAX's by design)."""
    out = {}
    for case in world.CASES:
        cfg, jbank = _jbank(case)
        model = JModel(cfg, remat=False)
        dec = JDecodeEngine(model=model, params=jbank, max_seq=32,
                            return_logits=True).generate(world.prompts(cfg), world.NEW)
        eng = JPagedEngine(model=model, params=jbank, num_slots=2, page_size=8,
                           max_seq=32, decode_chunk=4, return_logits=True)
        reqs = world.paged_requests(cfg)[:2]
        ids = [eng.submit(JRequest(tokens=t, max_new_tokens=n)) for t, n in reqs]
        comps = {c.request_id: c for c in eng.drain()}
        out[case] = {"tokens": np.asarray(dec.tokens), "logits": np.asarray(dec.logits),
                     "paged": [(np.asarray(comps[i].tokens), np.asarray(comps[i].logits))
                               for i in ids]}
    return out


def _expected_placements(case, shape, chains=True):
    """The reference's leaf specs for ``case`` on a ``(data, model)`` mesh
    of ``shape``, as DTensor placements path by path: its
    ``partition_tree`` through its ``sanitize_spec`` (its ``param_structs``);
    for a bank (``chains``) ``P(chain_axis, *spec)``, an entry naming the
    chain axis replicated."""
    cfg = _jcfg(case)
    mesh = SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
    like = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), cfg))
    specs = jax_partition_tree(like, cfg.param_sharding, cfg=cfg, model_size=shape[1])
    out = {}
    for (path, leaf), spec in zip(jax.tree_util.tree_flatten_with_path(like)[0],
                                  jax.tree_util.tree_leaves(
                                      specs, is_leaf=lambda s: isinstance(s, tuple))):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        entries = []
        for e in spec:  # a bank drops the chain axis ("data") from every entry
            axes = tuple(a for a in ((e,) if isinstance(e, str) else (e or ()))
                         if a != "data" or not chains)
            entries.append(None if not axes else axes[0] if len(axes) == 1 else axes)
        spec = tuple(jax_sanitize(jax.sharding.PartitionSpec(*entries), leaf.shape, mesh))
        spec = spec + (None,) * (len(leaf.shape) - len(spec))
        full = (("data",) if chains else ()) + spec
        pl = []
        for axis in ("data", "model"):
            dims = [i for i, e in enumerate(full)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            pl.append(f"S({dims[0]})" if dims else "R")
        out[name] = tuple(pl)
    return out


def _got(worlds, w, shape, case):
    return [r[(shape, case)] for r in _ranks(worlds, w)]


# ---------------------------------------------------------------------------
# serving from a 2-D bank
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w,shape,case", SERVED, ids=SERVED_IDS)
def test_2d_decode_matches_the_jax_package(worlds, jax_serving, w, shape, case):
    want = jax_serving[case]
    for got in _got(worlds, w, shape, case):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_allclose(got["logits"], want["logits"], **LOGIT_TOL)


@pytest.mark.parametrize("w,shape,case", SERVED, ids=SERVED_IDS)
def test_2d_paged_decode_matches_the_jax_package(worlds, jax_serving, w, shape, case):
    want = jax_serving[case]["paged"]
    for got in _got(worlds, w, shape, case):
        for (gt, gl), (wt, wl) in zip(got["paged"], want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_allclose(gl, wl, **LOGIT_TOL)


@pytest.mark.parametrize("w,shape,case", SERVED, ids=SERVED_IDS)
def test_2d_engines_match_the_unplaced_engines(worlds, w, shape, case):
    """Rank 0's unplaced engines on the whole bank: the decode request and
    the paged requests, the sampled one included."""
    got = _got(worlds, w, shape, case)[0]
    ref = got["ref"]
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    np.testing.assert_allclose(got["logits"], ref["logits"], **PLACED_TOL)
    for (gt, gl), (rt, rl) in zip(got["paged"], ref["paged"]):
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_allclose(gl, rl, **PLACED_TOL)


@pytest.mark.parametrize("w,shape,case", SERVED, ids=SERVED_IDS)
def test_every_rank_emits_the_same_tokens(worlds, w, shape, case):
    """The ranks decide from the same gathered bits: the same tokens, the
    same log-probs, the same paged completions (the sampled one too)."""
    got = _got(worlds, w, shape, case)
    for g in got[1:]:
        assert np.array_equal(g["tokens"], got[0]["tokens"])
        assert np.array_equal(g["logits"], got[0]["logits"])
        for (a, al), (b, bl) in zip(g["paged"], got[0]["paged"]):
            assert np.array_equal(a, b) and np.array_equal(al, bl)


@pytest.mark.parametrize("w,shape,case", SERVED, ids=SERVED_IDS)
def test_2d_placements_are_the_references_specs(worlds, w, shape, case):
    """Leaf by leaf, the placed bank's placements are the reference's
    ``P(chain_axis, *partition_tree spec)``, sanitized."""
    want = _expected_placements(case, shape)
    for got in _got(worlds, w, shape, case):
        assert {p: v[0] for p, v in got["params"].items()} == want


@pytest.mark.parametrize("w,shape,case", SERVED, ids=SERVED_IDS)
def test_no_rank_holds_more_than_its_block(worlds, w, shape, case):
    """Each leaf's local tensor is the global one cut by its placements;
    the decode cache and the page pool hold the rank's chains and its KV
    heads; and the bank gathers back whole, bit for bit."""
    axes = {"data": shape[0], "model": shape[1]}
    cfg = _jcfg(case)
    for got in _got(worlds, w, shape, case):
        for path, (pl, loc, glob) in got["params"].items():
            want = list(glob)
            for axis, p in zip(("data", "model"), pl):
                if p.startswith("S("):
                    d = int(p[2:-1])
                    want[d] //= axes[axis]
            assert list(loc) == want, path
        H, KV = got["heads"][:2]
        assert got["cache"][1] == got["pool"][1] == world.CASES[case][2] // shape[0]
        assert got["cache"][4] == got["pool"][4] == KV
        assert H * cfg.head_dim == got["params"]["stack/attn/wq"][1][-1]
        wk = got["params"]["stack/attn/wk"]
        if wk[0][1].startswith("S("):
            assert KV * cfg.head_dim == wk[1][-1]
        assert got["whole"]


@pytest.mark.parametrize("shape,heads", [((1, 2), [(2, 1, 0, 0), (2, 1, 2, 1)]),
                                         ((2, 2), [(2, 1, 0, 0), (2, 1, 2, 1)] * 2),
                                         ((1, 4), [(1, 1, r, r // 2) for r in range(4)])],
                         ids=["1x2", "2x2", "1x4"])
def test_the_local_heads_and_groups(worlds, shape, heads):
    """qwen3-4b reduced (4 query heads over 2 KV heads, G 2): at ``model`` 2
    a rank's 2 query heads over its KV head (G 2); at ``model`` 4 K/V is
    replicated and a rank's one query head reads KV head ``r // 2`` (G 1).
    Attention with 6 query heads over ``model`` 4 is replicated (all 6 over
    both KV heads on every rank)."""
    w = 2 if shape == (1, 2) else 4
    assert [g["heads"] for g in _got(worlds, w, shape, "qwen3")] == heads
    if shape == (1, 4):
        assert {g["heads"] for g in _got(worlds, 4, shape, "heads6")} == {(6, 2, 0, 0)}


QWEN3 = [(w, shape) for w, shape, case in SERVED if case == "qwen3"]
QWEN3_IDS = [f"{w} ranks-{shape[0]}x{shape[1]}" for w, shape in QWEN3]


@pytest.mark.parametrize("w,shape", QWEN3, ids=QWEN3_IDS)
def test_a_placed_cluster_state_serves_2d(worlds, w, shape):
    """A bank placed on the chain axis alone (a placed ``ClusterEngine``'s
    state) through ``DecodeEngine.from_cluster(..., shard_params=True)``:
    each rank cuts its block of each chain from its own rows; the engine's
    placements, tokens and log-probs are those of the engine that cut the
    whole bank, bit for bit."""
    for got in _got(worlds, w, shape, "qwen3"):
        fc = got["from_cluster"]
        assert fc["params"] == got["params"]
        assert np.array_equal(fc["tokens"], got["tokens"])
        assert np.array_equal(fc["logits"], got["logits"])


@pytest.mark.parametrize("w,shape", QWEN3, ids=QWEN3_IDS)
def test_the_vocabulary_parallel_lookup_is_the_whole_lookup(worlds, w, shape):
    """The masked lookup of a rank's rows summed over ``model``: exactly one
    rank adds each row, the others zeros, so the rows come back bit for
    bit."""
    for got in _got(worlds, w, shape, "qwen3"):
        assert got["lookup_bitwise"]


@pytest.mark.parametrize("w,shape", QWEN3, ids=QWEN3_IDS)
def test_param_structs_place_the_references_specs(worlds, w, shape):
    """``launch.steps.param_structs``: one chain's parameters with the
    placements of the reference's ``param_structs`` (``partition_tree``
    through ``sanitize_spec``, ``fsdp_axes`` ``("data",)``)."""
    want = _expected_placements("qwen3", shape, chains=False)
    for got in _got(worlds, w, shape, "qwen3"):
        assert got["param_structs"] == want


def test_a_long_prompt_takes_the_sdpa_prefill(worlds):
    """A 1,024-token prompt (SDPA on the rank's heads, above 512 positions)
    and 3 tokens from a 2-D bank: the unplaced engine's tokens, log-probs
    within 1e-5."""
    for got in _got(worlds, 2, (1, 2), "qwen3"):
        ref = _got(worlds, 2, (1, 2), "qwen3")[0]["long_ref"]
        assert np.array_equal(got["long"]["tokens"], ref["tokens"])
        np.testing.assert_allclose(got["long"]["logits"], ref["logits"], **PLACED_TOL)


def test_a_2d_bank_restores_straight_into_place(worlds):
    """``DecodeEngine.from_checkpoint(..., shard_params=True)`` reads each
    rank's block of each leaf from the file: the placements of the engine
    that cut a whole bank, and its tokens and log-probs bit for bit."""
    for got in _got(worlds, 2, (1, 2), "qwen3"):
        r = got["restored"]
        assert r["params"] == got["params"]
        assert np.array_equal(r["tokens"], got["tokens"])
        assert np.array_equal(r["logits"], got["logits"])


# ---------------------------------------------------------------------------
# expert parallelism against the JAX package's shard_map path
# ---------------------------------------------------------------------------
SCRIPT_MOE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
from dataclasses import replace
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.models.moe import apply_moe
from repro.utils import use_mesh

f = np.load(sys.argv[1])
cfg = replace(get_reduced("phi3.5-moe-42b-a6.6b"), dtype="float32",
              num_shared_experts=int(f["shared"]))
p = {k: jnp.asarray(f[k]) for k in f.files if k not in ("x", "shared")}
x = jnp.asarray(f["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"))
with use_mesh(mesh):
    y, aux = jax.jit(lambda p, x: apply_moe(p, x, cfg, mesh=mesh,
                                            batch_axes=("data",)))(p, x)
np.save(sys.argv[2], np.asarray(y))
print(json.dumps({"aux": float(aux)}))
"""


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_jax")
    _, arrs = _moe_inputs()
    np.savez(root / "moe.npz", shared=1, **arrs)
    res = run_json(SCRIPT_MOE.replace("sys.argv[1]", repr(str(root / "moe.npz")))
                   .replace("sys.argv[2]", repr(str(root / "y.npy"))), timeout=300)
    return np.load(root / "y.npy"), res["aux"]


def test_expert_parallel_moe_matches_the_jax_packages_shard_map(worlds, jax_moe):
    """phi3.5-moe reduced with a shared expert over ``data`` 2 x ``model``
    2, the batch split over ``data`` at the production capacity factor (so
    each data shard's capacity and drops, and ``aux`` averaged over the
    shards, are the JAX package's): every rank's rows within 1e-5, ``aux``
    within 1e-6."""
    y, aux = jax_moe
    for got in _ranks(worlds, 4):
        lo, hi = got["moe"]["rows"]
        np.testing.assert_allclose(got["moe"]["y"], y[lo:hi], rtol=1e-5, atol=1e-5)
        assert abs(got["moe"]["aux"] - aux) <= 1e-6


def test_every_model_rank_drops_the_same_pairs(worlds):
    """The drop ranks are computed over all of a rank's tokens: the model
    ranks of a data shard count the same dropped pairs."""
    got = [r["moe"] for r in _ranks(worlds, 4)]
    by_rows = {}
    for g in got:
        by_rows.setdefault(g["rows"], set()).add(g["dropped"])
    assert all(len(v) == 1 for v in by_rows.values()), by_rows


def test_phase_14s_moe_cell_runs_on_the_cpu(worlds):
    """``chip_smoke.py`` phase 14's cell, rehearsed on the CPU at
    phi3.5-moe's reduced widths in bf16 over ``data`` 1 x ``model`` 2: the
    ranks' streams bit for bit the same, the log-probs teacher-forced
    (under the placed run's expert choices) within the card's gate, and
    the unplaced engine, replaying the placed routing, dropping the pairs
    each rank dropped."""
    import chip_smoke

    got = [r["phase14"] for r in _ranks(worlds, 2)]
    runs = [g["placed"]["decode"] for g in got]
    assert runs[0]["digest"] == runs[1]["digest"] and runs[0]["tokens"] == 80
    assert got[0]["teacher_forced_rel"] <= chip_smoke.ZOO_REL_TOL
    assert [r["dropped"] for r in runs] == [got[0]["unplaced"]["decode"]["dropped"]] * 2


@pytest.mark.parametrize("name", [c[0] for c in world.REPLAY])
def test_phase_14s_replay_cells_run_on_the_cpu(worlds, name):
    """``chip_smoke.py`` phase 14 (d) rehearsed on the CPU at the reduced
    widths in bf16 over ``model`` 2, through the script's own gates:
    internvl2-1b's stub positions prefilled into a cache with room for the
    stream (a rank's KV 1 at G 2), hymba-1.5b's prompt replayed (its SSD
    channels split); greedy streams of the placed ``Model.serve_step``
    the same bits on both ranks, teacher-forced within the card's gate of
    the unplaced model's forward."""
    import chip_smoke

    ranks = [r["phase14_replay"] for r in _ranks(worlds, 2)]
    row = next(c for c in world.REPLAY if c[0] == name)
    cells = [(name, row[1], 2, "bfloat16", 2, *row[2:])]
    out = chip_smoke.model_axis_replay_report(ranks, cells)["cells"][name]
    assert out["teacher_forced_rel"] <= chip_smoke.ZOO_REL_TOL
    assert out["launches"] == [0, 0]  # the plain step on the CPU: no launch
    if name == "hymba-1.5b":
        assert out["ssm"] == [(0, 256), (256, 512)]
