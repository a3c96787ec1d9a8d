"""The recurrent configs end to end against the JAX package: hymba-1.5b
(attention and SSD heads in parallel, a sliding window) served by replay
past its window, the engines' refusals of both recurrent stacks, the
gradient oracle over xlstm-1.3b's ``layers`` list, the launcher, and the
``layers`` tree crossing ``from_jax_params``, ``drop_unit_chain`` and the
npz format both ways.

Reduced configs in float32 (weights from the JAX init, carried over), but
for the checkpoint crossing, which keeps the bf16 leaves.  Logits within
1e-4, as in ``tests/test_torch_archs.py``.
"""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import loss_fn as jax_loss_fn
from repro_torch import configs
from repro_torch.checkpoint import (
    checkpoint_step,
    leaf_paths,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.cluster import DecodeEngine, PagedDecodeEngine
from repro_torch.models.transformer import Model, init_params, loss_fn
from repro_torch.train.loop import make_grad_fn
from repro_torch.utils import tree_leaves, tree_map
from repro_torch.weights import drop_unit_chain, from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
RECURRENT = ["hymba-1.5b", "xlstm-1.3b"]


def _cfgs(arch, **over):
    return (replace(jconfigs.get_reduced(arch), dtype="float32", **over),
            replace(configs.get_reduced(arch), dtype="float32", **over))


def _np(t):
    return t.detach().cpu().numpy()


def test_hymba_replay_past_its_window():
    """128 tokens replayed through ``serve_step`` from ``init_cache`` on the
    reduced hymba (window 64: a ring of 64 slots that wraps twice, and
    positions that drop out of the window): every step's logits against the
    reference's replay and against the port's own ``forward`` of the same
    stream (the naive attention under the window mask, the SSD scan in
    chunks of 64)."""
    jcfg, tcfg = _cfgs("hymba-1.5b")
    assert tcfg.sliding_window == 64
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    B, T = 2, 128
    stream = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    jm, tm = JaxModel(jcfg, remat=False), Model(tcfg, device="cpu")
    jstep = jax.jit(jm.serve_step)
    jcache, tcache = jm.init_cache(B, T), tm.init_cache(B, T)
    assert tcache["attn"]["k"].shape[3] == 64
    got, want = [], []
    for t in range(T):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(stream[:, t:t + 1]), jnp.int32(t))
        tl, tcache = tm.serve_step(tparams, tcache, stream[:, t:t + 1], t)
        want.append(np.asarray(jl)[:, 0])
        got.append(_np(tl[0, :, 0]))
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_allclose(got, want, **TOL)
    full, _, _ = tm.forward(tparams, {"tokens": stream})
    np.testing.assert_allclose(got, _np(full[0]), **TOL)
    # the window matters: the same stream without it reads other positions
    nowin, _, _ = Model(replace(tcfg, sliding_window=None), device="cpu").forward(
        tparams, {"tokens": stream})
    assert np.abs(_np(nowin[0, :, 64:]) - got[:, 64:]).max() > 1e-2


@pytest.mark.parametrize("arch", RECURRENT)
def test_tap_teacher_forces_each_layer(arch):
    """The ``tap`` of ``Model.hidden`` and ``Model.serve_step`` (a 2-chain
    bank from ``init_cache``): it sees every layer's input and the last
    layer's output; a reading tap leaves both paths as they were; and
    feeding each layer of the replay the forward's input to it gives each
    layer's increment (output minus input) within 1e-4 of the forward's
    (what ``chip_smoke.py`` phase 11c gates xlstm-1.3b on)."""
    _, tcfg = _cfgs(arch)
    L, B, T = tcfg.num_layers, 2, 16
    params = init_params(tcfg, 0, device="cpu", num_chains=2)
    stream = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, T))
    tm = Model(tcfg, device="cpu")
    xs, read = [], []
    with torch.no_grad():
        x, _, _ = tm.hidden(params, {"tokens": stream}, tap=lambda i, x: xs.append(x) or x)
        assert len(xs) == L + 1 and torch.equal(xs[-1], x)
        assert torch.equal(x, tm.hidden(params, {"tokens": stream})[0])
        caches = [tm.init_cache(B, T, num_chains=2) for _ in range(3)]
        steps = [[] for _ in range(L)]
        for t in range(T):
            def force(i, x, t=t):
                if i:
                    steps[i - 1].append(x - xs[i - 1][:, :, t:t + 1])
                return xs[i][:, :, t:t + 1] if i < L else x
            tok = stream[:, t:t + 1]
            want, _ = tm.serve_step(params, caches[0], tok, t)
            got, _ = tm.serve_step(params, caches[1], tok, t,
                                   tap=lambda i, x: read.append(i) or x)
            assert torch.equal(got, want)
            tm.serve_step(params, caches[2], tok, t, tap=force)
    assert read == list(range(L + 1)) * T
    for i in range(L):
        np.testing.assert_allclose(_np(torch.cat(steps[i], 2)), _np(xs[i + 1] - xs[i]),
                                   **TOL, err_msg=f"layer {i}")


@pytest.mark.parametrize("arch", RECURRENT)
def test_engines_refuse_the_recurrent_stacks(arch):
    """``DecodeEngine``, ``PagedDecodeEngine``, ``init_cache_bank`` and
    ``prefill_cache`` refuse a stack without a prefill-fillable KV cache,
    with the reference's message; ``prefill`` returns the last logits and no
    cache, as the reference's."""
    jcfg, tcfg = _cfgs(arch)
    jm, tm = JaxModel(jcfg, remat=False), Model(tcfg, device="cpu")
    for engine in (DecodeEngine, PagedDecodeEngine):
        with pytest.raises(ValueError, match="homogeneous attention stack"):
            engine(tcfg, None, device="cpu")
    with pytest.raises(ValueError) as want:
        jm.init_cache_bank(1, 2, 8)
    with pytest.raises(ValueError) as got:
        tm.init_cache_bank(1, 2, 8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jm.prefill_cache(None, jnp.zeros((2, 4), jnp.int32), None, 4)
    with pytest.raises(ValueError) as got:
        tm.prefill_cache(None, np.zeros((2, 4), np.int32), None, 4)
    assert str(got.value) == str(want.value)
    jparams = jax_init(jax.random.PRNGKey(2), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tparams, {"tokens": toks})
    assert jc is None and tc is None
    np.testing.assert_allclose(_np(tl[0]), np.asarray(jl), **TOL)


def test_xlstm_published_pattern_matches_the_reference():
    """xlstm-1.3b's published 7:1 pattern (seven mLSTM blocks, then one
    sLSTM) over 8 layers, at the reduced widths: the ``layers`` list is
    cycled as the reference cycles it — logits, a gradient of every leaf,
    and four decode steps from ``init_cache`` against the reference's
    (decode logits within 1e-4).

    The forward's logits are held to the reference's own rounding: at 8
    layers the port's summation order moves a logit by about what one
    float32 ulp of the weights moves the reference's (each weight times 1
    +- 2^-23, signs from a seed).  Each logit lies within 1e-4 of its size
    plus twice that movement's largest reading; the sLSTM block's norm
    scaled by 1 + 2^-10 lies past it."""
    jcfg, tcfg = _cfgs("xlstm-1.3b", num_layers=8,
                       block_pattern=jconfigs.get_arch("xlstm-1.3b").block_pattern)
    jparams = jax_init(jax.random.PRNGKey(7), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert [sorted(layer) for layer in tparams["layers"]] == [
        sorted(layer) for layer in jparams["layers"]]
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    jm, tm = JaxModel(jcfg, remat=False), Model(tcfg, device="cpu")
    want, _, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks[:, :-1])})
    want = np.asarray(want)
    signs = np.random.default_rng(23)
    ulp = jax.tree_util.tree_map(lambda a: a * (1 + np.float32(2.0 ** -23) * signs.choice(
        np.array([-1, 1], np.float32), a.shape)), jparams)
    moved, _, _ = jm.forward(ulp, {"tokens": jnp.asarray(toks[:, :-1])})
    limit = 1e-4 * np.abs(want) + 2 * np.abs(np.asarray(moved) - want).max()
    got, _, _ = tm.forward(tparams, {"tokens": toks[:, :-1]})
    assert (np.abs(_np(got[0]) - want) <= limit).all()
    slstm = tparams["layers"][7]
    assert "slstm" in slstm
    fault = dict(tparams, layers=tparams["layers"][:7] + [
        dict(slstm, norm1=tree_map(lambda t: t * (1 + 2.0 ** -10), slstm["norm1"]))])
    faulty, _, _ = tm.forward(fault, {"tokens": toks[:, :-1]})
    assert not (np.abs(_np(faulty[0]) - want) <= limit).all()
    # the gradients grow with the depth (the embedding's reaches 22 here) and
    # so do the summation-order differences: each leaf within 1e-3 of its
    # norm (1e-4 of it at most on this seed), not 1e-4 of each entry
    jgrads = jax.grad(lambda p: jax_loss_fn(jm, p, {"tokens": jnp.asarray(toks)})[0])(jparams)
    grads, _ = make_grad_fn(tm)(tparams, {"tokens": toks})
    for g, w in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jgrads)):
        g, w = _np(g[0]), np.asarray(w)
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w)
    jcache, tcache = jm.init_cache(2, 8), tm.init_cache(2, 8)
    for t in range(4):
        jl, jcache = jm.serve_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tcache = tm.serve_step(tparams, tcache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_np(tl[0]), np.asarray(jl), **TOL)


def test_grad_fn_on_a_layers_list_equals_plain_autograd():
    """``make_grad_fn`` over xlstm's ``layers`` list (2 chains): each
    layer's leaves are autograd leaves as they are; every gradient equals
    autograd through the plain ``loss_fn`` of the same bank, leaf by leaf."""
    _, cfg = _cfgs("xlstm-1.3b")
    params = init_params(cfg, 4, device="cpu", num_chains=2)
    model = Model(cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 17)).astype(np.int64))}
    grads, metrics = make_grad_fn(model)(params, batch)
    assert isinstance(grads["layers"], list) and len(grads["layers"]) == cfg.num_layers
    plain = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = loss_fn(model, plain, batch)
    loss.backward()
    np.testing.assert_allclose(float(metrics["loss"]), float(loss.detach()), rtol=1e-6)
    got, want = tree_leaves(grads), [t.grad for t in tree_leaves(plain)]
    assert len(got) == len(want) == len(tree_leaves(params))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", RECURRENT)
def test_launcher_trains_a_recurrent_config_on_cpu(arch, tmp_path):
    """``launch.train --arch ... --reduced --device cpu --fused``: 6 W-Icon
    commits in chunks of 3 (the plain versions of the Langevin update and
    the W-Icon read on the CPU); its ``--save`` file is at step 6, and the
    JAX package restores it into its own tree, finite."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    path = str(tmp_path / "trained.npz")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--device", "cpu", "--steps", "6", "--chunk", "3", "--mode",
         "inconsistent", "--fused", "--tau", "2", "--batch", "2", "--seq", "32",
         "--save", path], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "mode=inconsistent (fused)" in res.stdout
    assert "step     2 loss" in res.stdout
    assert checkpoint_step(path) == 6
    like = jax_init(jax.random.PRNGKey(0), jconfigs.get_reduced(arch))
    got = jrestore(path, like)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(like)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert bool(jnp.isfinite(a.astype(jnp.float32)).all())


def test_xlstm_layers_tree_crosses_both_ways(tmp_path):
    """xlstm's ``layers`` list, bf16 weights and float32 biases: the JAX
    tree through ``from_jax_params`` (a chain axis of 1 on every leaf) and
    back through ``drop_unit_chain``, bit for bit; an npz written by either
    package restores in the other with the same bits."""
    jcfg = jconfigs.get_reduced("xlstm-1.3b")
    jparams = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(6), jcfg))
    tparams = from_jax_params(jparams, device="cpu")
    assert isinstance(tparams["layers"], list) and len(tparams["layers"]) == 2
    assert all(t.shape[0] == 1 for t in tree_leaves(tparams))

    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint8)

    def same(tree, want):
        paths = dict(leaf_paths(tree))
        wpaths = dict(leaf_paths(tree_map(lambda a: torch.zeros(a.shape), want)))
        assert paths.keys() == wpaths.keys()
        for (_, t), w in zip(leaf_paths(tree), jax.tree_util.tree_leaves(want)):
            got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
            assert np.array_equal(bits(got), bits(w))

    one = drop_unit_chain(tparams)
    same(one, jparams)
    port_file = str(tmp_path / "port.npz")
    save_checkpoint(port_file, one, step=2)
    same_j = jrestore(port_file, jax.tree_util.tree_map(jnp.asarray, jparams))
    for a, b in zip(jax.tree_util.tree_leaves(same_j), jax.tree_util.tree_leaves(jparams)):
        assert a.dtype == b.dtype and np.array_equal(bits(a), bits(b))
    jax_file = str(tmp_path / "jax.npz")
    jsave(jax_file, jax.tree_util.tree_map(jnp.asarray, jparams), step=2)
    back = restore_checkpoint(jax_file, tree_map(torch.zeros_like, one))
    same(back, jparams)


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_batch_twin_refuses_the_recurrent_stacks(arch, monkeypatch):
    """``examples/torch_serve_batch.py`` refuses a recurrent config before
    any work, with its twin's message (``examples/serve_batch.py``)."""
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    import torch_serve_batch

    with pytest.raises(SystemExit, match="recurrent archs serve via init_cache"):
        torch_serve_batch.main(["--arch", arch, "--device", "cpu"])
