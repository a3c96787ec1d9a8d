"""The long-prompt attention path and ``Model.prefill`` against the JAX
package, on the CPU, in float32.

Above 512 query positions (when both lengths divide into 512-position
chunks) the reference's ``attention_any`` takes its chunked
``flash_attention`` (a ``lax.scan`` with a hand-written backward); the
port's takes ``scaled_dot_product_attention`` with autograd's backward —
one call without a window, a call a query chunk with one (over only the
in-window key chunks, each with its own chunk's mask, whatever
``window_slice`` says).  The same numpy inputs go through both: outputs
and gradients within 1e-5 (the two sum the scores' softmax in another
order), against both of the reference's ``window_slice`` settings at
1,024 and 2,048 tokens, windows inside a chunk, of one, across chunks and
past the sequence.  The model-level tests use the reduced qwen3-4b (2
layers, d_model 256, 4 heads over 2 KV heads) carried over from the JAX
init: last-position logits within 1e-4 (the ROADMAP's logits tolerance),
the prefill cache within 1e-5, and the LM loss and its gradient at 1,024
tokens within 1e-4; and the reduced hymba-1.5b (a window of 64) against
the reference's under ``opt_window_slice`` likewise.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import attention as jattn
from repro.models.transformer import Model as JModel
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import loss_fn as jloss_fn
from repro_torch.configs import get_reduced
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import Model, loss_fn
from repro_torch.utils import tree_leaves
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _full_fp32_matmuls():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _qkv(seed, S, G, B=2, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, S, KV * G, hd), f(B, S, KV, hd), f(B, S, KV, hd), f(B, S, KV * G, hd)


@pytest.mark.parametrize("window", [None, 200], ids=["causal", "window-200"])
@pytest.mark.parametrize("G", [1, 2])
def test_long_path_forward_and_gradients_match_jax_flash(window, G):
    q, k, v, do = _qkv(G, 1024, G)
    assert 1024 % 512 == 0 and 1024 > 512  # the reference takes its flash path

    def jloss(q, k, v):
        return jnp.sum(jattn.attention_any(q, k, v, window=window) * do)

    want = jattn.attention_any(q, k, v, window=window)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tattn.attention_any(tq, tk, tv, window=window)
    (got * torch.from_numpy(do)).sum().backward()
    assert got.shape == q.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ATTN_TOL)
    for t, w in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **ATTN_TOL)


def _both_flash(q, k, v, do, *, window, window_slice, causal=True):
    """The reference's and the port's windowed flash path on the same
    inputs: ``(want, jax grads), (got, torch grads)``."""
    def jflash(q, k, v):
        return jattn.attention_any(q, k, v, causal=causal, window=window,
                                   window_slice=window_slice)

    want = jflash(q, k, v)
    jgrads = jax.grad(lambda *a: jnp.sum(jflash(*a) * do), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tattn.attention_any(tq, tk, tv, causal=causal, window=window,
                              window_slice=window_slice)
    (got * torch.from_numpy(do)).sum().backward()
    return (want, jgrads), (got, (tq.grad, tk.grad, tv.grad))


def _assert_flash_close(want, got):
    (w, jgrads), (g, tgrads) = want, got
    assert g.shape == w.shape
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **ATTN_TOL)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **ATTN_TOL)


@pytest.mark.parametrize("window_slice", [False, True], ids=["unsliced", "sliced"])
@pytest.mark.parametrize("window", [200, 512, 700, 1024, 4096])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S", [1024, 2048])
def test_windowed_path_matches_jax_flash(S, G, window, window_slice):
    """Forward and ``dq``, ``dk``, ``dv`` against ``jax.grad`` of the
    reference's flash path with each ``window_slice`` (its unsliced scan
    adds the out-of-window chunks masked whole): windows inside a
    chunk (200), of one (512), across two (700, 1,024) and past the
    sequence (4,096)."""
    q, k, v, do = _qkv(S + window + G, S, G)
    _assert_flash_close(*_both_flash(q, k, v, do, window=window,
                                     window_slice=window_slice))


@pytest.mark.parametrize("window_slice", [False, True], ids=["unsliced", "sliced"])
def test_windowed_path_without_causal_matches_jax_flash(window_slice):
    """A window without the causal mask: the port reads from the chunk of
    each query chunk's earliest in-window key to the last, the reference
    every chunk (it slices only under ``causal``)."""
    q, k, v, do = _qkv(31, 2048, 2)
    _assert_flash_close(*_both_flash(q, k, v, do, window=700, window_slice=window_slice,
                                     causal=False))


@pytest.mark.parametrize("window_slice", [False, True], ids=["unsliced", "sliced"])
def test_windowed_path_builds_no_full_mask(monkeypatch, window_slice):
    """Every mask the windowed path builds, forward and backward, is one
    query chunk's (512 rows) over the key chunks it reads: the in-window
    ones, 2 under a 512-token window (the reference's ``_n_win``), with
    ``window_slice`` or without; never ``(Sq, Sk)``."""
    shapes = []
    real = tattn._mask_block
    monkeypatch.setattr(tattn, "_mask_block", lambda qp, kp, c, w: shapes.append(
        (qp.shape[0], kp.shape[0])) or real(qp, kp, c, w))
    q, k, v, do = _qkv(9, 2048, 4)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, True, 512, window_slice=window_slice)
    (out * torch.from_numpy(do)).sum().backward()
    assert shapes == [(512, n) for n in (512, 1024, 1024, 1024)]
    assert tq.grad is not None and tk.grad is not None and tv.grad is not None


def test_windowed_path_without_causal_reads_from_the_window(monkeypatch):
    """Without ``causal`` a query chunk reads every key chunk from the one
    holding its first query's earliest in-window key (a 700-token window
    over 2,048 tokens: chunk 3 starts at keys 1,024..1,535)."""
    shapes = []
    real = tattn._mask_block
    monkeypatch.setattr(tattn, "_mask_block", lambda qp, kp, c, w: shapes.append(
        (qp.shape[0], kp.shape[0])) or real(qp, kp, c, w))
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(5, 2048, 2))
    tattn.flash_attention(q, k, v, False, 700)
    assert shapes == [(512, n) for n in (2048, 2048, 2048, 1536)]


def test_windowed_path_refuses_lengths_off_the_chunks():
    q = torch.zeros(1, 1000, 2, 16)
    with pytest.raises(ValueError, match="divide into chunks"):
        tattn.flash_attention(q, q, q, True, 200)


@pytest.mark.parametrize("S,long", [(256, False), (512, False), (1000, False),
                                    (1024, True)])
def test_dispatch_follows_the_reference_rule(S, long, monkeypatch):
    """Flash only when both lengths divide into 512-position chunks and
    there is more than one query chunk; else the naive path."""
    q, k, v, _ = _qkv(S, S, 2)
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = tattn.attention_any(*t)
    assert bool(calls) == long
    np.testing.assert_allclose(got.numpy(), tattn.naive_attention(*t).numpy(), **ATTN_TOL)
    if not long:
        np.testing.assert_array_equal(got.numpy(), tattn.naive_attention(*t).numpy())


# ---------------------------------------------------------------------------
# the model: prefill, the window cut, the loss at 1,024 tokens
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm():
    jcfg = replace(jax_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    jbank = jax.vmap(lambda k: jax_init(k, jcfg))(jax.random.split(jax.random.PRNGKey(0), 2))
    tbank = from_jax_params(jax.tree_util.tree_map(np.asarray, jbank), device="cpu")
    return jcfg, tcfg, jbank, tbank


def _prefill_both(jcfg, tcfg, jbank, tbank, toks):
    jm = JModel(jcfg, remat=False)
    want_logits, want_cache = jax.vmap(jm.prefill, in_axes=(0, None))(
        jbank, {"tokens": toks})
    with torch.no_grad():
        logits, cache = Model(tcfg, device="cpu").prefill(tbank, {"tokens": toks})
    return (want_logits, want_cache), (logits, cache)


@pytest.mark.parametrize("S", [9, 1024], ids=["short", "long"])
def test_prefill_matches_jax(lm, S):
    """Last-position logits ``(C, B, 1, V)`` and the cache (the port's is
    layer-major: ``(L, C, B, S, KV, hd)`` against JAX's vmapped
    ``(C, L, B, S, KV, hd)``), over the naive and the long path.  V within
    1e-5 at both lengths, K at 9 tokens; K at 1,024 within 1e-4: its rope
    takes float32 cos and sin of angles up to 1,023 rad, which ATen and
    XLA reduce differently (2.7e-5 apart already in layer 0, before any
    attention)."""
    jcfg, tcfg, jbank, tbank = lm
    toks = np.random.default_rng(S).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    (wl, wc), (gl, gc) = _prefill_both(jcfg, tcfg, jbank, tbank, toks)
    assert gl.shape == (2, 2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LOGIT_TOL)
    for name in ("k", "v"):
        assert gc["attn"][name].shape == (tcfg.num_layers, 2, 2, S, tcfg.num_kv_heads,
                                          tcfg.head_dim)
        tol = LOGIT_TOL if (name, S) == ("k", 1024) else ATTN_TOL
        np.testing.assert_allclose(gc["attn"][name].numpy(),
                                   np.asarray(wc["attn"][name]).swapaxes(0, 1), **tol)
    np.testing.assert_array_equal(gc["attn"]["pos"].numpy(), np.asarray(wc["attn"]["pos"][0]))


def test_prefill_cuts_the_cache_to_the_window(lm):
    jcfg, tcfg, jbank, tbank = lm
    jcfg, tcfg = (replace(c, sliding_window=4) for c in (jcfg, tcfg))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    (wl, wc), (gl, gc) = _prefill_both(jcfg, tcfg, jbank, tbank, toks)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LOGIT_TOL)
    assert gc["attn"]["k"].shape[3] == 4
    np.testing.assert_array_equal(gc["attn"]["pos"].numpy(), np.arange(5, 9))
    np.testing.assert_array_equal(gc["attn"]["pos"].numpy(), np.asarray(wc["attn"]["pos"][0]))
    for name in ("k", "v"):
        np.testing.assert_allclose(gc["attn"][name].numpy(),
                                   np.asarray(wc["attn"][name]).swapaxes(0, 1), **ATTN_TOL)


def test_prefill_unembeds_the_last_position_of_the_forward(lm):
    """The one row ``prefill`` unembeds is the forward's last row (within
    float rounding: the unembedding's matmul has another M)."""
    _, tcfg, _, tbank = lm
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (3, 7)).astype(np.int32)
    model = Model(tcfg, device="cpu")
    with torch.no_grad():
        full, _, _ = model.forward(tbank, {"tokens": toks})
        last, _ = model.prefill(tbank, {"tokens": toks})
    np.testing.assert_allclose(last.numpy(), full[:, :, -1:].numpy(), rtol=1e-5, atol=1e-5)


def test_loss_and_gradient_at_1024_tokens_match_jax(lm):
    """The training forward above 512 tokens takes the long path in both
    packages: CE and every parameter's gradient within 1e-4."""
    jcfg, tcfg, jbank, tbank = lm
    jp = jax.tree_util.tree_map(lambda x: x[0], jbank)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 1025)).astype(np.int32)
    jm = JModel(jcfg, remat=False)
    (jl, _), jg = jax.value_and_grad(lambda p: jloss_fn(jm, p, {"tokens": toks}),
                                     has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    loss, aux = loss_fn(Model(tcfg, device="cpu"), tp, {"tokens": toks})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **LOGIT_TOL)
    for t, w in zip(leaves, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(t.grad[0].numpy(), np.asarray(w), **LOGIT_TOL)


def test_hymba_loss_with_window_slice_matches_jax():
    """The reduced hymba-1.5b (a window of 64 over 512-token chunks) under
    ``opt_window_slice`` at 1,024 tokens: the loss and every gradient meet
    the reference's within 1e-4 (``tests/test_torch_model.py``'s
    tolerance)."""
    jcfg, tcfg = (replace(get("hymba-1.5b"), dtype="float32", opt_window_slice=True)
                  for get in (jax_reduced, get_reduced))
    jp = jax_init(jax.random.PRNGKey(3), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 1025)).astype(np.int32)
    jm = JModel(jcfg, remat=False)
    (jl, _), jg = jax.value_and_grad(lambda p: jloss_fn(jm, p, {"tokens": toks}),
                                     has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    loss, _ = loss_fn(Model(tcfg, device="cpu"), tp, {"tokens": toks})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **LOGIT_TOL)
    for t, w in zip(leaves, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(t.grad[0].numpy(), np.asarray(w), **LOGIT_TOL)
