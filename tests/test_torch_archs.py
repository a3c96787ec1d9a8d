"""The port's model zoo against the JAX package: the twin of
``tests/test_archs_smoke.py`` over every config of the reference: the
attention stacks, hymba-1.5b (attention and SSD heads in parallel, a
sliding window) and xlstm-1.3b (a heterogeneous ``layers`` list of mLSTM
and sLSTM blocks).

Each architecture's REDUCED variant in float32 (2 layers, d_model 256;
the MoE configs 4 experts, top-2; the frontend configs 16 or 8 stub
positions), one chain drawn by the JAX init and carried over with
:func:`repro_torch.weights.from_jax_params`; batches from numpy, handed
to both.  Tolerances: logits and decode logits within 1e-4 and every
gradient within 1e-4 (the same fp32 ops in the same order, only the
matmuls' summation order differs: XLA's CPU dot against ATen's); the
loss's ``ce`` and ``aux`` within 1e-5 relative (means of those logits).
Decode goes through the port's plain decode step (the CPU route of
``kernels.ops``) against the reference's unfused ``serve_step``, and the
engines over a 2-chain MoE bank against the reference's engines.
"""

from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.cluster import DecodeEngine as JaxDecodeEngine
from repro.cluster import PagedDecodeEngine as JaxPagedEngine
from repro.cluster.api import Request as JaxRequest
from repro.data import make_batch as jax_make_batch
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import loss_fn as jax_loss_fn
from repro_torch import configs, samplers
from repro_torch.cluster import ClusterEngine, DecodeEngine, PagedDecodeEngine, Request
from repro_torch.configs import ShapeConfig
from repro_torch.configs.base import ALIASES, ARCH_IDS
from repro_torch.core.sgld import SGLDConfig
from repro_torch.data import make_batch
from repro_torch.kernels.rng import PRNGKey
from repro_torch.models.transformer import FRONTEND_DIM, Model, init_params, loss_fn
from repro_torch.train.loop import make_grad_fn, make_train_step
from repro_torch.utils import tree_flatten, tree_map
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

IDS = sorted(ALIASES, key=lambda a: ARCH_IDS.index(ALIASES[a]))
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 24  # S positions a sequence, stub positions included


@pytest.fixture(autouse=True)
def _full_fp32_matmuls():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module", params=IDS)
def setup(request):
    arch = request.param
    jcfg = replace(jconfigs.get_reduced(arch), dtype="float32")
    tcfg = replace(configs.get_reduced(arch), dtype="float32")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    rng = np.random.default_rng(1)
    n_text = S - (jcfg.num_frontend_tokens if jcfg.frontend else 0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, n_text + 1)).astype(np.int32)}
    if jcfg.frontend:
        batch["frontend"] = rng.standard_normal(
            (B, jcfg.num_frontend_tokens, FRONTEND_DIM)).astype(np.float32)
    return arch, jcfg, tcfg, jparams, tparams, batch


def _np(t):
    return t.detach().cpu().numpy()


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", IDS)
def test_configs_match_the_reference(arch):
    """Every field the port keeps equals the reference's, full and reduced;
    so do the parameter counts (the port counts from its own init)."""
    for get in ("get_arch", "get_reduced"):
        jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
        for f in fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (get, f.name)
    red = (jconfigs.get_reduced(arch), configs.get_reduced(arch))
    assert red[1].param_count() == red[0].param_count()
    assert red[1].active_param_count() == red[0].active_param_count()


def test_registry_equals_the_references():
    """The port registers every architecture of the reference, under the
    same ids and aliases (hymba-1.5b and xlstm-1.3b included); an unknown
    id is refused at lookup."""
    assert ARCH_IDS == jconfigs.ARCH_IDS
    assert ALIASES == jconfigs.ALIASES
    for arch in ("hymba-1.5b", "xlstm-1.3b"):
        assert configs.get_arch(arch).name == arch
    with pytest.raises(ValueError, match="no architecture"):
        configs.get_arch("mamba-3b")


def test_forward_logits_match(setup):
    arch, jcfg, tcfg, jparams, tparams, batch = setup
    inp = dict(batch, tokens=batch["tokens"][:, :-1])
    want, jaux, _ = JaxModel(jcfg, remat=False).forward(jparams, _jax_batch(inp))
    got, aux, _ = Model(tcfg, device="cpu").forward(tparams, _torch_batch(inp))
    assert got.shape == (1, B, S, jcfg.vocab_size)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(aux), [float(jaux)], rtol=1e-5, atol=1e-7)


def test_loss_ce_and_aux_match(setup):
    arch, jcfg, tcfg, jparams, tparams, batch = setup
    jtotal, jm = jax_loss_fn(JaxModel(jcfg, remat=False), jparams, _jax_batch(batch))
    total, m = loss_fn(Model(tcfg, device="cpu"), tparams, _torch_batch(batch))
    for name in ("ce", "aux"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    if jcfg.num_experts:
        assert float(m["aux"]) > 0
    else:
        assert float(m["aux"]) == 0.0


def test_gradients_match_on_every_leaf(setup):
    arch, jcfg, tcfg, jparams, tparams, batch = setup
    jm = JaxModel(jcfg, remat=False)
    jgrads = jax.grad(lambda p: jax_loss_fn(jm, p, _jax_batch(batch))[0])(jparams)
    grads, metrics = make_grad_fn(Model(tcfg, device="cpu"))(tparams, _torch_batch(batch))
    want = dict(_paths(jax.tree_util.tree_map(np.asarray, jgrads)))
    got = dict(_paths(grads))
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(_np(g[0]), want[name], **TOL, err_msg=name)
    assert np.isfinite(float(metrics["loss"]))


def test_sync_sgld_step_updates_params(setup):
    arch, jcfg, tcfg, jparams, tparams, batch = setup
    params = tree_map(torch.clone, tparams)
    sampler, step_fn = make_train_step(
        Model(tcfg, device="cpu"), SGLDConfig(mode="sync", gamma=1e-3, sigma=1e-8))
    state = sampler.init(params, (0, 2))
    before = tree_map(torch.clone, state.params)
    new, metrics = step_fn(state, _torch_batch(batch), 0)
    assert np.isfinite(float(metrics["loss"]))
    diffs = [float((a - b).abs().max()) for a, b in
             zip(tree_flatten(new.params)[0], tree_flatten(before)[0])]
    assert max(diffs) > 0
    assert all(bool(torch.isfinite(t).all()) for t in tree_flatten(new.params)[0])


def test_serve_step_from_init_cache_matches(setup):
    """Four cached decode steps from an empty ``init_cache`` (frontend
    configs too, as the reference's ``init_cache`` allows; the recurrent
    stacks' SSD / xLSTM state), teacher-forced with the same tokens, against
    the reference's unfused ``serve_step``: logits and every cache leaf."""
    arch, jcfg, tcfg, jparams, tparams, batch = setup
    feed = np.random.default_rng(2).integers(0, jcfg.vocab_size, (4, B, 1)).astype(np.int32)
    jm = JaxModel(jcfg, remat=False)
    tm = Model(tcfg, device="cpu")
    jcache, tcache = jm.init_cache(B, 8), tm.init_cache(B, 8)
    for t, tok in enumerate(feed):
        jl, jcache = jm.serve_step(jparams, jcache, jnp.asarray(tok), jnp.int32(t))
        tl, tcache = tm.serve_step(tparams, tcache, tok, t)
        assert tl.shape == (1, B, 1, jcfg.vocab_size)
        np.testing.assert_allclose(_np(tl[0]), np.asarray(jl), **TOL)
    want = dict(_paths(jax.tree_util.tree_map(np.asarray, jcache)))
    got = dict(_paths(tcache))
    assert got.keys() == want.keys()
    for name, t in got.items():
        # a stack's cache is layer-major (L, C, ...), a list's entries (C, ...)
        t = t if name.endswith("pos") else (t[0] if isinstance(tcache, list) else t[:, 0])
        np.testing.assert_allclose(_np(t), want[name], **TOL, err_msg=name)


@pytest.mark.parametrize("arch", IDS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_has_the_references_shapes(arch, kind):
    jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    shape = ShapeConfig("t", seq_len=32, global_batch=3, kind=kind)
    want = jax_make_batch(jcfg, jconfigs.ShapeConfig("t", 32, 3, kind),
                          jax.random.PRNGKey(0))
    got = make_batch(tcfg, shape, torch.Generator().manual_seed(0))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "cur_pos":
            assert got[k] == int(v)
            continue
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype), k
    if "tokens" in got:
        assert int(got["tokens"].min()) >= 0
        assert int(got["tokens"].max()) < tcfg.vocab_size


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"])
def test_engines_serve_an_moe_bank_as_the_reference(arch):
    """``DecodeEngine`` and ``PagedDecodeEngine`` over a 2-chain MoE bank
    (routing and capacity per chain) against the reference's engines
    (unfused decode): equal greedy tokens, BMA log-probs within 1e-4."""
    jcfg = replace(jconfigs.get_reduced(arch), dtype="float32")
    tcfg = replace(configs.get_reduced(arch), dtype="float32")
    jbank = jax.vmap(lambda k: jax_init(k, jcfg))(jax.random.split(jax.random.PRNGKey(3), 2))
    tbank = from_jax_params(jax.tree_util.tree_map(np.asarray, jbank), device="cpu")
    jm = JaxModel(jcfg, remat=False)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (3, 6)).astype(np.int32)
    want = JaxDecodeEngine(model=jm, params=jbank, max_seq=32,
                           return_logits=True).generate(toks, 5)
    got = DecodeEngine(tcfg, tbank, max_seq=32, return_logits=True,
                       device="cpu").generate(toks, 5)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits, np.asarray(want.logits), **TOL)

    def paged(engine_cls, req_cls, model, bank):
        eng = engine_cls(model=model, params=bank, num_slots=2, page_size=8,
                         max_seq=32, decode_chunk=3, return_logits=True,
                         **({} if engine_cls is JaxPagedEngine else {"device": "cpu"}))
        ids = [eng.submit(req_cls(tokens=t, max_new_tokens=n))
               for t, n in zip(rng_reqs, (4, 6, 3))]
        done = {c.request_id: c for c in eng.drain()}
        return [done[i] for i in ids]

    rng_reqs = [rng.integers(0, jcfg.vocab_size, (t,)).astype(np.int32) for t in (5, 3, 7)]
    for g, w in zip(paged(PagedDecodeEngine, Request, tcfg, tbank),
                    paged(JaxPagedEngine, JaxRequest, jm, jbank)):
        assert g.status == w.status == "ok"
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.logits, w.logits, **TOL)


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_engines_refuse_frontend_configs(arch):
    """The engines' banks serve token prompts only, as the reference's
    ``_require_stacked_attention`` says; ``init_cache`` takes them."""
    tcfg = configs.get_reduced(arch)
    model = Model(tcfg, device="cpu")
    assert model.init_cache(2, 8)["attn"]["k"].shape[1:3] == (1, 2)
    for make in (lambda: model.init_cache_bank(1, 2, 8),
                 lambda: model.init_paged_bank(1, 4, 8)):
        with pytest.raises(ValueError, match="token prompts only"):
            make()
    for engine in (DecodeEngine, PagedDecodeEngine):
        with pytest.raises(ValueError, match="token prompts only"):
            engine(tcfg, None, device="cpu")


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "internvl2-1b"])
def test_cluster_engine_trains_an_moe_and_a_frontend_config(arch):
    """``ClusterEngine`` takes any registered config unchanged: 2 chains,
    fused W-Icon at tau 1, batches (stub embeddings too) from ``batch_fn``;
    finite losses, the MoE's aux above 0, every chain moved."""
    cfg = replace(configs.get_reduced(arch), dtype="float32")
    shape = ShapeConfig("t", seq_len=S, global_batch=2, kind="train")
    sampler = samplers.sgld("inconsistent", make_grad_fn(Model(cfg, device="cpu")),
                            gamma=1e-3, sigma=1e-5, tau=1, has_aux=True, fused=True)
    engine = ClusterEngine(sampler, num_chains=2, chunk_size=2, collect_aux=True,
                           batch_fn=lambda g: make_batch(cfg, shape, g, "train"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", num_chains=1)
    state = engine.init(params, PRNGKey(0))
    before = tree_map(torch.clone, state.params)
    state, aux = engine.run(state, steps=2, schedule=np.array([0, 1]), key=3)
    assert aux["loss"].shape == (2, 2) and np.isfinite(aux["loss"]).all()
    assert (aux["aux"] > 0).all() if cfg.num_experts else (aux["aux"] == 0).all()
    moved = (state.params["stack"]["attn"]["wq"] - before["stack"]["attn"]["wq"])
    assert bool((moved.flatten(1).abs().amax(dim=1) > 0).all())
