"""repro_torch.cluster engines against repro.cluster's, request for request.

The reduced qwen3-4b in float32, a bank of C = 2 chains drawn by the JAX
init and carried over with ``from_jax_params``.  The JAX engines run with
``fused=True`` (the Pallas decode kernels in interpret mode).  Greedy token
ids must be equal, and the per-token BMA log-probs agree to 1e-4 (fp32 on
both sides; only matmul summation orders differ).  The JAX package's own
bitwise greedy claim is not used as an oracle.

A bf16 bank compares log-probs at atol 0.1: bf16 rounds activations after
every projection in both packages, at places that differ (measured
differences reach 0.045 on log-probs that span ~5 nats).  Tokens are not
compared there; log-probs only up to the first step where the two token
streams part.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.cluster import DecodeEngine as JaxDecodeEngine
from repro.cluster import PagedDecodeEngine as JaxPagedEngine
from repro.cluster.api import Request as JaxRequest
from repro.configs import get_reduced as jax_reduced
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro_torch.cluster import DecodeEngine, PagedDecodeEngine, Request
from repro_torch.configs import get_reduced
from repro_torch.kernels import rng
from repro_torch.weights import from_jax_params

C = 2
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _full_fp32_matmuls():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _setup(dtype):
    jcfg = replace(jax_reduced("qwen3-4b"), dtype=dtype)
    tcfg = replace(get_reduced("qwen3-4b"), dtype=dtype)
    jbank = jax.vmap(lambda k: jax_init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), C))
    tbank = from_jax_params(jax.tree_util.tree_map(np.asarray, jbank),
                            device="cpu")
    return JaxModel(jcfg, remat=False), jbank, tcfg, tbank


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


def prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (t,)).astype(np.int32) for t in lens]


def test_decode_engine_greedy_matches_jax(f32):
    jm, jbank, tcfg, tbank = f32
    toks = np.stack(prompts(tcfg.vocab_size, [5, 5, 5]))
    want = JaxDecodeEngine(model=jm, params=jbank, max_seq=32, fused=True,
                           return_logits=True).generate(toks, 6)
    eng = DecodeEngine(tcfg, tbank, max_seq=32, return_logits=True,
                       device="cpu")
    got = eng.generate(toks, 6)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logits, np.asarray(want.logits), **TOL)
    # a second, shorter request reuses the rung's cache bank
    again = eng.generate(toks[:2, :3], 4)
    want2 = JaxDecodeEngine(model=jm, params=jbank, max_seq=32, fused=True,
                            return_logits=True).generate(toks[:2, :3], 4)
    np.testing.assert_array_equal(again.tokens, np.asarray(want2.tokens))
    assert eng.num_host_pad_allocs == 2


def _paged_run(engine_cls, req_cls, model, bank, reqs, **kw):
    """Fill both slots with low-priority requests, pump once, then submit
    the rest (one at higher priority, which preempts) and drain."""
    eng = engine_cls(model=model, params=bank, num_slots=2, page_size=8,
                     max_seq=32, decode_chunk=3, return_logits=True, **kw)
    ids, early = [], []
    for i, (toks, n, prio) in enumerate(reqs):
        if i == 2:
            early = eng.step()
        ids.append(eng.submit(req_cls(tokens=toks, max_new_tokens=n,
                                      priority=prio)))
    done = {c.request_id: c for c in early + eng.drain()}
    return eng, [done[i] for i in ids]


def test_paged_engine_mixed_lengths_and_preemption_match_jax(f32):
    jm, jbank, tcfg, tbank = f32
    ps = prompts(tcfg.vocab_size, [5, 3, 7, 2, 6])
    reqs = [(ps[0], 9, 0), (ps[1], 7, 0), (ps[2], 4, 5), (ps[3], 6, 0),
            (ps[4], 3, 0)]
    _, want = _paged_run(JaxPagedEngine, JaxRequest, jm, jbank, reqs,
                         fused=True)
    eng, got = _paged_run(PagedDecodeEngine, Request, tcfg, tbank, reqs,
                          device="cpu")
    assert sum(c.timing.get("evictions", 0) for c in got) == 1
    for g, w, (_, n, _) in zip(got, want, reqs):
        assert g.status == w.status == "ok"
        assert len(g.tokens) == n
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.logits, w.logits, **TOL)
    assert eng.free_pages == eng.num_pages - 1 and eng.num_active == 0


def test_paged_sampling_is_a_function_of_seed_and_position(f32):
    """Sampled requests: the same key gives the same tokens alone, beside
    other requests, and after a preemption and replay (each token's key
    folds in its absolute position); another key gives other tokens."""
    _, _, tcfg, tbank = f32
    p = prompts(tcfg.vocab_size, [4, 6, 3], seed=3)

    def run(reqs, pump_after=None):
        eng = PagedDecodeEngine(tcfg, tbank, num_slots=2, page_size=8,
                                max_seq=32, decode_chunk=2, device="cpu")
        ids, early = [], []
        for i, r in enumerate(reqs):
            if i == pump_after:
                early = eng.step()
            ids.append(eng.submit(r))
        done = {c.request_id: c for c in early + eng.drain()}
        return [done[i] for i in ids]

    alone = run([Request(tokens=p[0], max_new_tokens=8, key=rng.PRNGKey(11))])[0]
    crowd = run([Request(tokens=p[0], max_new_tokens=8, key=rng.PRNGKey(11)),
                 Request(tokens=p[1], max_new_tokens=8, key=rng.PRNGKey(12)),
                 Request(tokens=p[2], max_new_tokens=5, priority=3)],
                pump_after=2)
    assert crowd[0].timing.get("evictions", 0) + \
        crowd[1].timing.get("evictions", 0) == 1
    np.testing.assert_array_equal(crowd[0].tokens, alone.tokens)
    other = run([Request(tokens=p[0], max_new_tokens=8, key=rng.PRNGKey(13))])[0]
    assert not np.array_equal(other.tokens, alone.tokens)
    greedy = run([Request(tokens=p[0], max_new_tokens=8)])[0]
    assert not np.array_equal(greedy.tokens, alone.tokens)


def test_decode_engine_sampling_is_reproducible(f32):
    _, _, tcfg, tbank = f32
    toks = np.stack(prompts(tcfg.vocab_size, [4, 4]))
    eng = DecodeEngine(tcfg, tbank, max_seq=16, device="cpu")
    a = eng.generate(toks, 5, key=rng.PRNGKey(2))
    b = eng.generate(toks, 5, key=rng.PRNGKey(2))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(a.tokens[0], a.tokens[1])  # per-row streams
    assert ((a.tokens >= 0) & (a.tokens < tcfg.vocab_size)).all()


def test_bf16_bank_log_probs_match_jax_loosely():
    jm, jbank, tcfg, tbank = _setup("bfloat16")
    toks = np.stack(prompts(tcfg.vocab_size, [6, 6]))
    want = JaxDecodeEngine(model=jm, params=jbank, max_seq=16, fused=True,
                           return_logits=True).generate(toks, 4)
    got = DecodeEngine(tcfg, tbank, max_seq=16, return_logits=True,
                       device="cpu").generate(toks, 4)
    want_t, want_l = np.asarray(want.tokens), np.asarray(want.logits)
    for b in range(toks.shape[0]):
        same = np.cumprod(got.tokens[b] == want_t[b])  # steps before a split
        upto = int(same.sum()) + 1                    # + the step that split
        np.testing.assert_allclose(got.logits[b, :upto], want_l[b, :upto],
                                   rtol=0, atol=0.1)


def test_engines_need_a_card_unless_asked_for_the_cpu(f32, monkeypatch):
    _, _, tcfg, tbank = f32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (DecodeEngine, PagedDecodeEngine):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(tcfg, tbank)
    # a bank on one device cannot be served from another
    with pytest.raises(ValueError, match="lies on"):
        DecodeEngine(tcfg, tbank, device="meta")
