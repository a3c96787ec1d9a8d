"""repro_torch.models against repro.models on the same weights.

The reduced qwen3-4b (2 layers, d_model 256, 4 heads, 2 KV heads, hd 64,
vocab 512) in float32, a bank of C = 2 chains.  The JAX bank is drawn once
by the JAX init and carried over with :func:`repro_torch.weights.
from_jax_params`; prompts come from numpy.  Logits agree to 1e-4: both
sides compute in fp32 with the same op order, and only the summation order
of the matmuls differs (XLA's CPU dot vs ATen's).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import Model, init_params
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

C = 2
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _full_fp32_matmuls():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def cfgs():
    return (replace(jax_reduced("qwen3-4b"), dtype="float32"),
            replace(get_reduced("qwen3-4b"), dtype="float32"))


@pytest.fixture(scope="module")
def banks(cfgs):
    jcfg, _ = cfgs
    jbank = jax.vmap(lambda k: jax_init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), C))
    host = jax.tree_util.tree_map(np.asarray, jbank)
    return jbank, from_jax_params(host, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


def test_config_and_param_count_match(cfgs):
    jcfg, tcfg = cfgs
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "qk_norm", "rope_theta"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    assert tcfg.param_count() == jcfg.param_count()


def test_init_params_layout_matches_jax(cfgs, banks):
    """The port's own init draws the JAX package's tree: same keys, same
    shapes, same dtypes, with the chain axis leading."""
    _, tcfg = cfgs
    _, tbank = banks
    mine = init_params(tcfg, 0, device="cpu", num_chains=C)
    flat = lambda t: {k: v for k, v in _items(t)}  # noqa: E731
    want, got = flat(tbank), flat(mine)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].shape == got[k].shape and want[k].dtype == got[k].dtype, k


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_forward_matches_jax(cfgs, banks):
    jcfg, tcfg = cfgs
    jbank, tbank = banks
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    jm = JaxModel(jcfg, remat=False)
    want = jax.vmap(lambda p: jm.forward(p, {"tokens": toks})[0])(jbank)
    got, _, _ = Model(tcfg, device="cpu").forward(tbank, {"tokens": toks})
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_prefill_cache_and_serve_step_match_jax(cfgs, banks):
    """Bucket-padded prefill into the cache bank, then four cached decode
    steps teacher-forced with the same tokens, against the JAX model's
    (unfused) ``prefill_cache`` + ``serve_step`` vmapped over the bank."""
    jcfg, tcfg = cfgs
    jbank, tbank = banks
    rng = np.random.default_rng(1)
    B, T, T_pad, max_seq = 2, 5, 8, 16
    toks = rng.integers(0, jcfg.vocab_size, (B, T_pad)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab_size, (4, B)).astype(np.int32)

    jm = JaxModel(jcfg, remat=False)
    jcache = jax.vmap(lambda _: jm.init_cache(B, max_seq))(jnp.arange(C))
    jlast, jcache = jax.vmap(jm.prefill_cache, in_axes=(0, None, 0, None))(
        jbank, toks, jcache, T)
    tm = Model(tcfg, device="cpu")
    tcache = tm.init_cache_bank(C, B, max_seq)
    tlast, tcache = tm.prefill_cache(tbank, toks, tcache, T)
    np.testing.assert_allclose(_np(tlast), np.asarray(jlast), **TOL)

    step = jax.vmap(jm.serve_step, in_axes=(0, 0, None, None))
    for i, tok in enumerate(feed):
        jl, jcache = step(jbank, jcache, tok[:, None], T + i)
        tl, tcache = tm.serve_step(tbank, tcache, tok[:, None], T + i)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    # the port's cache is layer-major (L, C, ...); JAX's bank is (C, L, ...)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _np(tcache["attn"][name]),
            np.asarray(jcache["attn"][name]).swapaxes(0, 1), **TOL)
    np.testing.assert_array_equal(_np(tcache["attn"]["pos"]),
                                  np.asarray(jcache["attn"]["pos"][0]))


def test_paged_prefill_and_paged_step_match_jax(cfgs, banks):
    """Two slots on permuted pages of one pool per chain, a third slot
    inactive on the garbage page; prefill one slot, then three steps."""
    jcfg, tcfg = cfgs
    jbank, tbank = banks
    rng = np.random.default_rng(2)
    n_pages, ps, maxp = 9, 4, 4
    tables = np.zeros((3, maxp), np.int32)
    tables[0] = [7, 2, 5, 0]
    tables[1] = [3, 8, 1, 6]
    T0, T1 = 6, 3
    p0 = rng.integers(0, jcfg.vocab_size, (1, 8)).astype(np.int32)
    p1 = rng.integers(0, jcfg.vocab_size, (1, 4)).astype(np.int32)

    jm = JaxModel(jcfg, remat=False)
    jpages = jm.init_paged_bank(C, n_pages, ps)
    tm = Model(tcfg, device="cpu")
    tpages = tm.init_paged_bank(C, n_pages, ps)
    jpre = jax.vmap(jm.paged_prefill, in_axes=(0, None, 0, None, None))
    for toks, tbl, T in ((p0, tables[0], T0), (p1, tables[1], T1)):
        jl, jpages = jpre(jbank, toks, jpages, jnp.asarray(tbl), T)
        tl, tpages = tm.paged_prefill(tbank, toks, tpages, tbl, T)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)

    jstep = jax.vmap(jm.paged_step, in_axes=(0, 0, None, None, None))
    pos = np.array([T0, T1, 0], np.int32)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jpages = jstep(jbank, jpages, jnp.asarray(tables), tok, jnp.asarray(pos))
        tl, tpages = tm.paged_step(tbank, tpages, tables, tok, pos)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        pos = pos + np.array([1, 1, 0], np.int32)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _np(tpages[name]), np.asarray(jpages[name]).swapaxes(0, 1), **TOL)


def test_model_needs_a_card_unless_asked_for_the_cpu(cfgs, monkeypatch):
    _, tcfg = cfgs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(tcfg, 0)
    Model(tcfg, device="cpu")


def test_resolve_device_names_the_card_as_tensors_do(monkeypatch):
    """A bare "cuda" becomes "cuda:<current>", the device tensors report,
    so an engine on "cuda" accepts a bank on "cuda:0"."""
    from repro_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda:0")
    assert resolve_device(torch.device("cuda", 0)) == torch.device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
