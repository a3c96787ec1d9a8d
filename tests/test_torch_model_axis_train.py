"""The port's training on the model axis — the ``sync`` and ``pipeline``
SGLD steps on a ``(data, model)`` mesh with a tensor- and expert-parallel
model, a vocabulary-parallel loss, the batch over ``data`` and the noise
at each element's global counter — in gloo worlds on the CPU, against the
JAX package's unplaced step.

Two worlds are spawned once for the module
(``tests/torch_model_axis_train_world.py``, each rank a process that
imports no JAX, meeting at a ``FileStore``): 2 ranks over ``data`` 1 x
``model`` 2, and 4 ranks over ``data`` 2 x ``model`` 2, ``data`` 1 x
``model`` 4 and ``pod`` 2 x ``data`` 1 x ``model`` 2.  The cases are the
reference test's step (qwen3-4b reduced in float32, ``seq_len`` 64, a
global batch of 4 in 2 microbatches) and its layouts: the head-sharded
attention (K/V replicated, each rank the columns of the KV heads its
queries read), 6 query heads (replicated over ``model`` 4), a 511-word
vocabulary (embedding and head replicated), phi3.5-moe reduced at the
production capacity factor, kimi-k2 reduced with its shared expert under
its own ``fsdp_tp`` (the experts' ``d_ff`` over ``data``, gathered a
layer), and ``fsdp_full`` (the ``"fsdp"`` option: every weight over every
axis, gathered where it is used, the batch over every axis; at a global
batch of 8 and of 4).  The fixtures and the JAX package's results are made
here, the results while the worlds run.

The oracle is the JAX package's unplaced ``make_sgld_train_step``: under
``jit`` a placement does not change what the step computes, except in the
MoE block's ``shard_map``, where each data shard takes its own capacity;
for a MoE over ``data`` 2 it is the unplaced step's gradient function on
each shard's rows of each microbatch, the gradients and losses averaged,
then the reference's noise and update.  (The reference's own sharded step
test is one of its known failures on XLA's CPU.)  Gates: the loss within
1e-5 relative, every leaf's gradient block within 1e-4 relative L2, the
new parameters within 1e-6, each noise block the block of the port's
unplaced ``noise="jax"`` draw bit for bit, every rank's loss the same
bits.
"""

import os
import pickle
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_model_axis_train_world as world
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_arch as jax_arch
from repro.configs import get_reduced as jax_reduced
from repro.configs import get_shape as jax_shape
from repro.launch import steps as jax_steps
from repro.models.transformer import Model as JModel
from repro.models.transformer import init_params as jax_init
from repro.samplers.transforms import noise_like as jax_noise_like
from repro.samplers.transforms import sgld_apply as jax_sgld_apply
from repro.train.loop import make_grad_fn as jax_grad_fn
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch, get_shape
from repro_torch.kernels import rng
from repro_torch.launch import steps
from repro_torch.weights import from_jax_params

HERE = Path(__file__).parent
WORLD_TIMEOUT = 600  # seconds for both worlds, spawned together (a guard against a hang)
WORLDS = [2, 4]
LOSS_RTOL, GRAD_REL, NEW_ATOL = 1e-5, 1e-4, 1e-6
#: every (world, mesh shape, case) the worlds train
TRAINED = [(w, shape, case) for w in WORLDS for shape, cases in world.MESHES[w]
           for case in cases]
TRAINED_IDS = [f"{w} ranks-{'x'.join(map(str, shape))}-{case}" for w, shape, case in TRAINED]
#: the oracles the worlds wait for: (case, data shards)
ORACLES = sorted({(world.oracle_case(case), world.shards(case, shape))
                  for _, shape, case in TRAINED})


def _jcfg(case):
    return world.config(case, jax_reduced)


def _jparams(case):
    return jax_init(jax.random.PRNGKey(0), _jcfg(case))


def _pending(jparams):
    g = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray((0.01 * g.standard_normal(p.shape)).astype(np.float32),
                              p.dtype), jparams)


def _tokens(case):
    vocab = _jcfg(case).vocab_size
    return np.random.default_rng(11).integers(
        0, vocab, (world.batch_of(case), world.SEQ + 1)).astype(np.int32)


def _batch(case):
    """The case's global batch: its tokens, and a frontend config's stub
    embeddings ``(B, FRONTEND_N, 1024)`` float32."""
    batch = {"tokens": _tokens(case)}
    if _jcfg(case).frontend:
        batch["frontend"] = np.random.default_rng(12).standard_normal(
            (world.batch_of(case), world.FRONTEND_N, 1024)).astype(np.float32)
    return batch


def _port(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _shard_rows(d, D):
    """Data shard ``d``'s rows of the global batch, microbatch by
    microbatch, as GSPMD splits each microbatch over ``data``."""
    per = world.BATCH // world.MICRO
    sub = per // D
    return np.concatenate([np.arange(i * per + d * sub, i * per + (d + 1) * sub)
                           for i in range(world.MICRO)])


def _oracle(case, D):
    """The JAX package's step on ``case``: ``(loss, grads, new params of
    sync, of pipeline)``.  ``D`` > 1 (a MoE over ``data``): the unplaced
    gradient function on each shard's rows, averaged, then the reference's
    noise and update."""
    cfg = _jcfg(case)
    jshape = JShapeConfig("t", world.SEQ, world.batch_of(case), "train",
                          num_microbatches=world.MICRO)
    model = JModel(cfg, remat=False)
    params = _jparams(case)
    pend = _pending(params)
    batch = {k: jnp.asarray(v) for k, v in _batch(case).items()}
    keys = {m: jax.random.PRNGKey(s) for m, s in world.KEYS.items()}
    if D == 1:
        sync, pipe = (jax_steps.make_sgld_train_step(model, jshape, mode, world.GAMMA,
                                                     world.SIGMA)
                      for mode in ("sync", "pipeline"))
        both = jax.jit(lambda p, q, b: (sync(p, b, keys["sync"]),
                                        pipe(p, q, b, keys["pipeline"])))
        (new_sync, loss), (new_pipe, grads, _) = both(params, pend, batch)
        return float(loss), grads, new_sync, new_pipe
    grad_fn = jax.jit(jax_grad_fn(model, world.MICRO))
    outs = [grad_fn(params, {k: v[_shard_rows(d, D)] for k, v in batch.items()})
            for d in range(D)]
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / D, *[o[0] for o in outs])
    loss = sum(float(o[1]["loss"]) for o in outs) / D
    scale = jnp.float32((2.0 * world.SIGMA * world.GAMMA) ** 0.5)
    gamma = jnp.float32(world.GAMMA)

    def update(g, key):
        return jax_sgld_apply(params, g, gamma,
                              jax_noise_like(key, params, scale, jnp.float32))

    return loss, grads, update(grads, keys["sync"]), update(pend, keys["pipeline"])


def _save_oracle(root, name, loss, grads, new_sync, new_pipe):
    save_checkpoint(str(root / f"{name}_oracle.npz"),
                    {"grads": _port(grads), "sync": _port(new_sync),
                     "pipeline": _port(new_pipe)})
    np.save(root / f"{name}_loss.npy", np.float64(loss))
    (root / f"{name}.done").touch()


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Write the fixtures, spawn both worlds, write the JAX package's
    results while they run, wait for them (killing every rank on
    timeout), and load each rank's results: ``{world: ([each rank's], log
    text)}``."""
    root = tmp_path_factory.mktemp("model_axis_train")
    for case in world.CASES:
        params = _jparams(case)
        save_checkpoint(str(root / f"{case}.npz"), _port(params))
        save_checkpoint(str(root / f"{case}_pending.npz"), _port(_pending(params)))
        for name, a in _batch(case).items():
            np.save(root / f"{case}_{name}.npy", a)
    procs = {}
    for w in WORLDS:
        out = root / f"world{w}"
        out.mkdir()
        procs[w] = [subprocess.Popen(
            [sys.executable, str(HERE / "torch_model_axis_train_world.py"), str(r), str(w),
             str(root / f"store{w}"), str(out), str(root)],
            stdout=open(out / f"log{r}.txt", "w"), stderr=subprocess.STDOUT,
            start_new_session=True) for r in range(w)]
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
        with ThreadPoolExecutor(4) as pool:  # while the worlds run (XLA frees the GIL)
            jobs = {pool.submit(_oracle, case, D): (case, D) for case, D in ORACLES}
            results = ((jobs[f], f.result()) for f in as_completed(jobs))
            for (case, D), (loss, grads, new_sync, new_pipe) in results:
                _save_oracle(root, world.oracle_name(case, D), loss, grads, new_sync,
                             new_pipe)
        timed_out = False
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


def _got(worlds, w, shape, case):
    ranks, logs = worlds[w]
    if ranks is None:
        pytest.fail(f"the {w}-rank world failed:\n{logs}")
    return [r[(shape, case)] for r in ranks]


# ---------------------------------------------------------------------------
# the step against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w,shape,case", TRAINED, ids=TRAINED_IDS)
def test_the_loss_matches_the_jax_packages_step(worlds, w, shape, case):
    for got in _got(worlds, w, shape, case):
        for mode in ("sync", "pipeline"):
            assert abs(got["loss"][mode] - got["loss_ref"]) <= \
                LOSS_RTOL * abs(got["loss_ref"]), (mode, got["loss"], got["loss_ref"])


@pytest.mark.parametrize("w,shape,case", TRAINED, ids=TRAINED_IDS)
def test_every_leafs_gradient_matches_jax_grad(worlds, w, shape, case):
    """The pipeline step's returned gradient, each rank's block of each
    leaf, against ``jax.grad``'s through the JAX package's step: a leaf
    counted ``m`` times or ``1/m`` times over ``model``, or a sum over the
    ranks missing from the backward, fails here."""
    for got in _got(worlds, w, shape, case):
        bad = {p: r for p, r in got["grads"].items() if not r <= GRAD_REL}
        assert not bad, bad


@pytest.mark.parametrize("w,shape,case", TRAINED, ids=TRAINED_IDS)
def test_the_new_parameters_match_the_jax_packages_step(worlds, w, shape, case):
    for got in _got(worlds, w, shape, case):
        bad = {k: d for k, d in got["new"].items() if not d <= NEW_ATOL}
        assert not bad, bad
        assert got["gathered_whole"] <= NEW_ATOL  # the blocks gathered whole


@pytest.mark.parametrize("w,shape,case", TRAINED, ids=TRAINED_IDS)
def test_each_noise_block_is_the_unplaced_draws_block_bit_for_bit(worlds, w, shape, case):
    for got in _got(worlds, w, shape, case):
        assert all(got["noise_bitwise"].values()), got["noise_bitwise"]


@pytest.mark.parametrize("w,shape,case", TRAINED, ids=TRAINED_IDS)
def test_every_rank_has_the_same_loss_bits(worlds, w, shape, case):
    got = _got(worlds, w, shape, case)
    assert all(g["loss"] == got[0]["loss"] for g in got[1:])


@pytest.mark.parametrize("w,shape,case", TRAINED, ids=TRAINED_IDS)
def test_no_rank_holds_more_than_its_block(worlds, w, shape, case):
    """Each leaf's parameters, gradient, noise and new parameters on a rank
    are the global leaf cut by its placements: the chain axis replicated,
    the sanitized spec on each mesh axis — ``model`` in the
    tensor-parallel layouts (the batch axes then hold only rows), every
    axis under ``fsdp_full``, ``data`` too for ``fsdp_tp``'s experts."""
    for got in _got(worlds, w, shape, case):
        axes = got["axes"]
        split = set()
        for path, (pl, glob, held) in got["held"].items():
            assert "S(0)" not in pl, (path, pl)
            want = list(glob)
            for axis, p in zip(axes, pl):
                if p.startswith("S("):
                    want[int(p[2:-1])] //= axes[axis]
                    if axes[axis] > 1:
                        split.add(axis)
            assert all(list(s) == want for s in held.values()), (path, held, want)
        fsdp = case in world.FSDP and axes["data"] > 1 or case.startswith("fsdp")
        assert (split - {"model"} != set()) == fsdp, (split, case)


@pytest.mark.parametrize("w,shape,case", TRAINED, ids=TRAINED_IDS)
def test_noise_torch_is_refused_on_a_placed_step(worlds, w, shape, case):
    for got in _got(worlds, w, shape, case):
        for what, msg in got["refused"].items():
            assert msg is not None and "'jax'" in msg, (what, msg)


# ---------------------------------------------------------------------------
# the layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w,shape,case,summed", [
    (2, (1, 2), "qwen3", ["stack/attn/k_norm", "stack/attn/q_norm"]),
    (2, (1, 2), "head-shard", ["stack/attn/bk", "stack/attn/bv", "stack/attn/k_norm",
                               "stack/attn/q_norm", "stack/attn/wk", "stack/attn/wv"]),
    (4, (1, 4), "qwen3", ["stack/attn/k_norm", "stack/attn/q_norm", "stack/attn/wk",
                          "stack/attn/wv"]),
    (4, (1, 4), "heads6", []),
    (2, (1, 2), "phi-moe", ["stack/moe/router"]),
    (4, (2, 2), "kimi-moe", ["stack/moe/router"]),
    (2, (1, 2), "hymba", ["stack/ssm/bc_proj", "stack/ssm/conv_b", "stack/ssm/norm"]),
    (2, (1, 2), "hymba-cut", ["stack/ssm/a_log", "stack/ssm/bc_proj", "stack/ssm/conv_b",
                              "stack/ssm/d_skip", "stack/ssm/dt_bias", "stack/ssm/dt_w",
                              "stack/ssm/norm"]),
    (4, (1, 4), "hymba", ["stack/attn/wk", "stack/attn/wv", "stack/ssm/bc_proj",
                          "stack/ssm/conv_b", "stack/ssm/norm"]),
    (4, (2, 2), "xlstm", []),
    (4, (1, 4), "internvl2", ["stack/attn/bk", "stack/attn/bv", "stack/attn/wk",
                              "stack/attn/wv"]),
], ids=["qwen3-1x2", "head-shard-1x2", "qwen3-1x4", "heads6-1x4", "phi-moe-1x2",
        "kimi-moe-2x2", "hymba-1x2", "hymba-cut-1x2", "hymba-1x4", "xlstm-2x2",
        "internvl2-1x4"])
def test_the_leaves_summed_over_model(worlds, w, shape, case, summed):
    """The leaves a rank uses on its part only, whose gradient is summed
    over ``model``: the qk-norms on a rank's heads; a replicated K/V
    projection under ``kv_take`` (qwen3's 2 KV heads over ``model`` 4:
    two ranks read each); the router beside a rank's experts.  With the
    attention replicated (6 heads over 4) nothing is summed: every rank's
    gradient is already whole.  (Reduced qwen3 has no qkv bias, so ``bk`` /
    ``bv`` are absent but named where the layout would sum them.)  hymba's
    SSD heads: the replicated leaves a rank uses its channels of
    (``bc_proj``, ``conv_b``, ``norm``; with 5 heads on 2 ranks also
    ``dt_w`` and the per-head vectors, which the axis does not divide); an
    xLSTM block is computed whole on every rank: nothing summed."""
    for got in _got(worlds, w, shape, case):
        present = {p.replace("##", "/") for p in got["held"]}
        assert got["summed"] == [p for p in summed if p in present]


def test_kimi_k2s_experts_split_d_ff_over_data_in_training(worlds):
    """kimi-k2's own ``fsdp_tp``: a rank holds its experts over ``model``
    with their ``d_ff`` halved over ``data`` (``w_gate`` / ``w_up`` on
    their last dimension, ``w_down`` on its rows), gathered for the layer
    as the reference's ``shard_map`` all-gathers them."""
    for got in _got(worlds, 4, (2, 2), "kimi-moe"):
        for name, dim in (("w_gate", 4), ("w_up", 4), ("w_down", 3)):
            pl, glob, held = got["held"][f"stack##moe##{name}"]
            assert pl == (f"S({dim})", "S(2)"), (name, pl)
            assert held["params"][dim] * 2 == glob[dim]
            assert held["params"][2] * 2 == glob[2]  # the experts over model


@pytest.mark.parametrize("w,shape,case", [t for t in TRAINED if t[2] in world.FSDP],
                         ids=[i for t, i in zip(TRAINED, TRAINED_IDS) if t[2] in world.FSDP])
def test_fsdp_holds_one_layer_gathered_at_a_time(worlds, w, shape, case):
    """FSDP's gathered bytes alive at once (counted in the gather itself,
    each gathered tensor until it is freed) never exceed the largest
    layer's leaves plus the embedding and the head — each layer's weights
    are freed with its forward and gathered again for its backward — and
    stay under the whole model's two layers; a layout with nothing to
    gather (``data`` 1) gathers nothing."""
    for got in _got(worlds, w, shape, case):
        g = got["gathered"]
        if got["axes"]["data"] == 1 and not case.startswith("fsdp"):
            assert g["peak"] == 0
            continue
        assert 0 < g["peak"] <= g["layer_and_ends"] < g["model"], g


def test_the_batch_specs_split_the_rows_over_data(worlds):
    for got in _got(worlds, 4, (2, 2), "qwen3"):
        assert got["batch_specs"] == {"tokens": ("S(0)", "R")}
    for got in _got(worlds, 4, (2, 2), "internvl2"):  # the stub embeddings' rows too
        assert got["batch_specs"] == {"tokens": ("S(0)", "R"), "frontend": ("S(0)", "R")}


# ---------------------------------------------------------------------------
# the configs with a layout of their own
# ---------------------------------------------------------------------------
OWN = [t for t in TRAINED if t[2] in world.OWN_LAYOUTS]
OWN_IDS = [i for t, i in zip(TRAINED, TRAINED_IDS) if t[2] in world.OWN_LAYOUTS]


@pytest.mark.parametrize("w,shape,case", OWN, ids=OWN_IDS)
def test_the_placed_model_decodes_like_the_unplaced_one(worlds, w, shape, case):
    """hymba (its SSD state of the rank's channels, a cut head's too), xLSTM
    (replicated blocks) and the frontend configs (the stub positions
    prefilled, then tokens): the log-probs of a teacher-forced replay
    through the placed ``Model.serve_step`` within 1e-4 (f32) of the
    unplaced model's (which ``tests/test_torch_recurrent.py`` and
    ``test_torch_archs.py`` hold against the JAX package)."""
    for got in _got(worlds, w, shape, case):
        assert got["decode"] <= 1e-4, got["decode"]


@pytest.mark.parametrize("w,shape,case", OWN, ids=OWN_IDS)
def test_the_engines_still_refuse_recurrent_and_frontend_stacks_placed(worlds, w, shape,
                                                                         case):
    """The engines' banks stay refused on a mesh as off it: the recurrent
    stacks have no prefill-fillable cache, the frontend configs serve
    token prompts only."""
    want = "token prompts only" if case in ("internvl2", "musicgen") \
        else "homogeneous attention stack"
    for got in _got(worlds, w, shape, case):
        for what, msg in got["refused_bank"].items():
            assert msg is not None and want in msg, (what, msg)


@pytest.mark.parametrize("w,shape,case", OWN, ids=OWN_IDS)
def test_a_placed_chain_round_trips_to_the_whole_leaves(worlds, w, shape, case):
    """Every leaf's block (hymba's ``in_proj`` ``[x | z]``, ``conv_w``'s
    taps and ``dt_w``'s heads as the reference's specs cut them) gathered
    over ``model`` is the whole leaf; ``gather_chains`` gives the whole
    chain; a placed checkpoint reads back whole and placed, bit for bit."""
    for got in _got(worlds, w, shape, case):
        assert all(got["round_trip"].values()), got["round_trip"]


@pytest.mark.parametrize("w,shape,case,channels,gathered,state", [
    (2, (1, 2), "hymba", [(0, 256), (256, 512)],
     ["a_log", "conv_w", "d_skip", "dt_bias", "dt_w", "in_proj"],
     [((2, 1, 2, 2, 128, 16), (2, 1, 2, 3, 256))] * 2),
    (2, (1, 2), "hymba-cut", [(0, 320), (320, 640)], ["conv_w", "in_proj"],
     [((2, 1, 2, 3, 128, 16), (2, 1, 2, 3, 320))] * 2),
    (4, (1, 4), "hymba-cut", [(0, 160), (160, 320), (320, 480), (480, 640)],
     ["conv_w", "in_proj"],
     [((2, 1, 2, 2, 128, 16), (2, 1, 2, 3, 160))] * 4),
    (4, (2, 2), "xlstm", [None] * 2, [], [None] * 2),
], ids=["hymba-1x2", "hymba-cut-1x2", "hymba-cut-1x4", "xlstm-2x2"])
def test_the_ssd_heads_split_by_channel(worlds, w, shape, case, channels, gathered, state):
    """Each rank's run of ``di / m`` SSD channels (in rank order along
    ``model``), the leaves whose reference blocks are not that run and are
    gathered where the layer runs, and the rank's decode state: ``ssm_h``
    over the heads its channels touch (a cut head on both ranks),
    ``ssm_conv`` over its channels."""
    for r, got in enumerate(_got(worlds, w, shape, case)):
        m = r % shape[-1]
        assert got["ssm"] == (channels[m], gathered)
        assert got.get("ssm_state") == state[m]


@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2)], ids=["2x2", "2x1x2"])
def test_a_fsdp_full_batch_is_split_over_every_axis(worlds, shape):
    """``build_model`` gives a ``fsdp_full`` model every axis as its batch
    axes when the global batch divides by the mesh's size, as the
    reference's does."""
    for got in _got(worlds, 4, shape, "fsdp"):
        assert got["batch_axes"] == world.axis_names(shape)
        assert got["batch_specs"] == {"tokens": ("S(0)",) * len(shape)}


# ---------------------------------------------------------------------------
# the pieces that need no world
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,block", [
    ((1, 6, 10), (slice(None), slice(2, 4), slice(3, 7))),
    ((3, 5, 8, 4), (slice(1, 2), slice(None), slice(4, 8), slice(0, 2))),
    ((257,), (slice(128, 257),)),
], ids=["strided", "4-d", "rows"])
def test_a_block_draw_is_the_block_of_jaxs_draw(monkeypatch, shape, block):
    """``rng.jax_normal`` / ``jax_uniform`` of a block of a global shape:
    the block of ``jax.random``'s draw of the whole, bit for bit, through
    slices smaller than the block (``CHUNK`` cut to 7)."""
    monkeypatch.setattr(rng, "CHUNK", 7)
    key = (0, 42)
    jkey = jax.random.PRNGKey(42)
    want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))[block]
    np.testing.assert_array_equal(rng.jax_normal(key, shape, block=block).numpy(), want)
    want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, -1.0, 2.0))[block]
    np.testing.assert_array_equal(
        rng.jax_uniform(key, shape, -1.0, 2.0, block=block).numpy(), want)


def test_the_counter_limit_is_still_refused():
    """A leaf's draw takes counters past 2^32 (its block of a 2^32-element
    leaf, at the whole leaf's counters: ``tests/test_torch_rng.py`` holds
    them bit for bit against JAX's); past the 64-bit counter it is
    refused."""
    z = rng.jax_normal((0, 1), (2**16, 2**16), block=(slice(2**16 - 1, None), slice(0, 2)))
    assert z.shape == (1, 2) and np.isfinite(z.numpy()).all()
    with pytest.raises(ValueError, match="64-bit counter"):
        rng.jax_normal((0, 1), (2**32, 2**32), block=(slice(0, 1), slice(0, 1)))


def test_adapt_config_takes_attn_shard_as_the_reference():
    """``"attn_shard"`` sets ``opt_attn_head_shard`` and ``"fsdp"`` sets
    ``param_sharding="fsdp_full"`` (clearing the head-sharded layout), as
    the reference's ``adapt_config`` does, field for field; ``"fsdp"`` on a
    MoE is refused as the reference asserts; ``"window_slice"`` and
    ``"unroll"`` set their fields as the reference's do."""
    from dataclasses import asdict

    for arch in ("qwen3-4b", "phi3.5-moe-42b-a6.6b"):
        got = steps.adapt_config(get_arch(arch), get_shape("train_4k"), ("attn_shard",))
        want = jax_steps.adapt_config(jax_arch(arch), jax_shape("train_4k"),
                                      ("attn_shard",))
        assert got.opt_attn_head_shard is want.opt_attn_head_shard is True
    for arch in ("qwen3-4b", "minicpm-2b", "hymba-1.5b"):
        for opts in (("fsdp",), ("attn_shard", "fsdp"), ("window_slice", "unroll")):
            got = steps.adapt_config(get_arch(arch), get_shape("train_4k"), opts)
            want = jax_steps.adapt_config(jax_arch(arch), jax_shape("train_4k"), opts)
            assert asdict(got) == asdict(want)
            if "fsdp" in opts:
                assert got.param_sharding == "fsdp_full" and not got.opt_attn_head_shard
            else:
                assert got.opt_window_slice and got.opt_unroll_layers
    for arch in ("kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b"):
        with pytest.raises(ValueError, match="dense"):
            steps.adapt_config(get_arch(arch), get_shape("train_4k"), ("fsdp",))
        with pytest.raises(AssertionError, match="dense"):
            jax_steps.adapt_config(jax_arch(arch), jax_shape("train_4k"), ("fsdp",))


def test_the_shard_rows_are_the_gspmd_split():
    """The oracle's rows of each data shard: microbatch i's rows split
    over ``data`` (rows 0, 2 and 1, 3 of a batch of 4 in 2 microbatches)."""
    assert _shard_rows(0, 2).tolist() == [0, 2]
    assert _shard_rows(1, 2).tolist() == [1, 3]


def test_phase_15s_cells_run_on_the_cpu(worlds):
    """``chip_smoke.py`` phase 15's cells rehearsed on the CPU over ``data`` 2
    x ``model`` 2 at the reduced widths (phi3.5-moe in bf16 against the
    per-shard oracle under the placed run's expert choices, qwen3-4b in
    f32), through the script's own report and gates; a step's collectives
    by kind."""
    import chip_smoke

    ranks, logs = worlds[4]
    if ranks is None:
        pytest.fail(f"the 4-rank world failed:\n{logs}")
    rows = [(name, arch, 2, dtype, None, *tol, layouts)
            for name, arch, dtype, tol, layouts in world.PHASE15]
    out = chip_smoke.model_axis_train_report([r["phase15"] for r in ranks], rows)
    f32 = out["qwen3-4b-f32"]["collectives"][-1]
    # 2 microbatches: the lookup and 2 a layer forward, a column-parallel
    # entry each backward, 3 the loss; the qk-norms summed; 14 leaves and
    # the metrics averaged over data
    assert f32 == {"forward": 10, "backward": 10, "loss": 6, "model sum": 2,
                   "data mean": 15}
    # (d) at reduced widths: the batch over both axes, one row a rank, every
    # weight gathered for its use (the embedding, the head, 7 a layer and
    # again in its recompute) and its gradient summed over the four ranks,
    # the 5 norms and the metrics averaged over each axis; nothing on the
    # activations
    fsdp = out["qwen3-4b-f32 fsdp_full"]
    assert fsdp["layout"] == "fsdp_full" and fsdp["batch_axes"] == ["data", "model"]
    assert fsdp["collectives"][-1] == {"fsdp gather": 30, "fsdp reduce": 16,
                                       "data mean": 12}
    # (e): phi3.5-moe's experts' d_ff over data, gathered a layer
    tp = out["phi3.5-moe fsdp_tp"]
    assert tp["layout"] == "fsdp_tp" and tp["collectives"][-1]["fsdp gather"] > 0
    assert max(tp["block_gb"]) < max(out["phi3.5-moe"]["block_gb"])


def test_phase_15s_hymba_and_xlstm_cells_run_on_the_cpu(worlds):
    """Phase 15's (f) and (g) rehearsed at the reduced widths through the
    script's own gates: hymba in bf16, its SSD heads split by channel (their
    leaves gathered where the layer runs — a tensor-parallel gather, not
    FSDP's — and the replicated ones summed over ``model``); xlstm in f32,
    its blocks replicated (no ``model`` sum; its step at its own gamma)."""
    import chip_smoke

    ranks, logs = worlds[4]
    if ranks is None:
        pytest.fail(f"the 4-rank world failed:\n{logs}")
    rows = [(name, arch, 2, dtype, None, *tol, layouts)
            for name, arch, dtype, tol, layouts in world.PHASE15
            if name in ("hymba-1.5b", "xlstm-1.3b")]
    out = chip_smoke.model_axis_train_report([r["phase15"] for r in ranks], rows)
    hymba, xlstm = (out[n]["collectives"][-1] for n in ("hymba-1.5b", "xlstm-1.3b"))
    assert hymba["model sum"] == 3 and "fsdp gather" not in hymba  # bc_proj, conv_b, norm
    assert "model sum" not in xlstm and max(out["xlstm-1.3b"]["gathered_gb"]) == 0
    assert out["hymba-1.5b"]["grad_rel_max"] <= 0.05
    assert out["xlstm-1.3b"]["grad_rel_max"] <= 1e-4
