"""Sampled tokens: the port's draws against ``jax.random``'s, and the serving
engines' sampled requests against the JAX package's engines.

- ``rng.gumbel`` / ``rng.categorical`` bit for bit against
  ``jax.random.gumbel`` / ``jax.random.categorical`` (float32, the
  ``mode="low"`` draw) at ``(V,)``, ``(4, 1000)`` and ``(3, 151936)``, under
  ``split`` and ``fold_in`` keys; the batched form (a key a row) against
  ``vmap(jax.random.categorical)``.
- ``DecodeEngine.generate(..., key=k)`` on a 2-chain reduced qwen3-4b bank
  (JAX init, carried over by ``from_jax_params``): the JAX engine's tokens
  exactly in float32, the log-probs within ``TOL``; in bf16 the log-probs
  within 0.1 up to the first step where the token streams part.
- ``PagedDecodeEngine``: sampled and greedy requests with one preemption,
  request by request the JAX paged engine's tokens.

Keys go in every form a caller may hand over: an int seed, the port's
``(k0, k1)`` pair and a ``(2,)`` uint32 array of a JAX key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import DecodeEngine as JaxDecodeEngine
from repro.cluster import PagedDecodeEngine as JaxPagedEngine
from repro.cluster.api import Request as JaxRequest
from repro_torch.cluster import DecodeEngine, PagedDecodeEngine, Request
from repro_torch.kernels import rng
from test_torch_engines import TOL, _setup, prompts
from torch_cases import one_cpu_thread  # noqa: F401

SHAPES = [(1000,), (4, 1000), (3, 151936)]


def _keys():
    """A ``split`` key and a ``fold_in`` of one, as JAX keys."""
    k = jax.random.split(jax.random.PRNGKey(3), 4)[2]
    return {"split": k, "fold_in": jax.random.fold_in(k, 17)}


def _pair(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", ["split", "fold_in"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_is_jax_random_gumbel_bit_for_bit(shape, kind):
    k = _keys()[kind]
    want = jax.random.gumbel(k, shape, jnp.float32)
    got = rng.gumbel(_pair(k), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("kind", ["split", "fold_in"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_categorical_is_jax_random_categorical(shape, kind):
    k = _keys()[kind]
    # BMA-like log-probs: a softmax's log over random logits (float32)
    logp = np.array(jax.nn.log_softmax(
        3.0 * jax.random.normal(jax.random.PRNGKey(1), shape), axis=-1))
    want = np.asarray(jax.random.categorical(k, jnp.asarray(logp), axis=-1))
    got = rng.categorical(_pair(k), torch.from_numpy(logp))
    np.testing.assert_array_equal(got.numpy(), want)
    # a row's counters follow from its index, whatever the batch: the first
    # row alone draws the first row's token
    if len(shape) == 2:
        alone = rng.categorical(_pair(k), torch.from_numpy(logp[:1]))
        assert int(alone[0]) == int(want[0])


@pytest.mark.parametrize("V", [1000, 151936])
def test_rows_form_is_vmapped_fold_in_and_categorical(V):
    """The paged engine's draw: a key a slot, ``fold_in(key_s, pos_s + 1)``,
    then one categorical a row — ``vmap`` of JAX's, in one pass."""
    S = 5
    keys = jax.random.split(jax.random.PRNGKey(9), S)
    pos = (np.arange(S) * 7 + 3).astype(np.int32)
    kt = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos + 1))
    got_kt = rng.fold_in_rows(np.asarray(keys), pos + 1)
    np.testing.assert_array_equal(got_kt.numpy(), np.asarray(kt).astype(np.int64))
    logp = np.array(jax.nn.log_softmax(
        2.0 * jax.random.normal(jax.random.PRNGKey(2), (S, V)), axis=-1))
    want = np.asarray(jax.vmap(jax.random.categorical)(kt, jnp.asarray(logp)))
    got = rng.categorical_rows(got_kt, torch.from_numpy(logp))
    np.testing.assert_array_equal(got.numpy(), want)
    # each row is the single-key draw of that row alone
    for s in (0, S - 1):
        one = rng.categorical(tuple(got_kt[s].tolist()), torch.from_numpy(logp[s]))
        assert int(one) == int(want[s])


def test_keys_are_read_in_every_form_and_a_generator_is_refused():
    jk = jax.random.fold_in(jax.random.PRNGKey(4), 2)
    pair = _pair(jk)
    assert rng.as_key(7) == _pair(jax.random.PRNGKey(7))
    assert rng.as_key(np.asarray(jk)) == rng.as_key(pair) == pair
    assert rng.as_key(torch.tensor(pair)) == pair
    assert rng.as_key(np.uint32(9)) == _pair(jax.random.PRNGKey(9))
    # requests keep the pair, so equal keys group by value
    assert Request(tokens=np.zeros(2, np.int32), key=np.asarray(jk)).key == pair
    assert Request(tokens=np.zeros(2, np.int32)).key is None
    with pytest.raises(TypeError, match="torch.Generator"):
        rng.as_key(torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="two 32-bit words"):
        rng.as_key((1, 2, 3))


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


@pytest.mark.parametrize("form", ["int", "pair", "jax_array"])
def test_decode_engine_samples_the_jax_engines_tokens(f32, form):
    """Three rows share one key (one draw over the (B, V) block a step, as
    the reference's scan); a second generate call at another key reuses
    the rung's cache."""
    jm, jbank, tcfg, tbank = f32
    toks = np.stack(prompts(tcfg.vocab_size, [5, 5, 5], seed=1))
    eng = DecodeEngine(tcfg, tbank, max_seq=32, return_logits=True, device="cpu")
    jeng = JaxDecodeEngine(model=jm, params=jbank, max_seq=32, fused=True,
                           return_logits=True)
    for seed in (11, 12):
        jk = jax.random.PRNGKey(seed)
        key = {"int": seed, "pair": _pair(jk), "jax_array": np.asarray(jk)}[form]
        want = jeng.generate(toks, 6, key=jk)
        got = eng.generate(toks, 6, key=key)
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(got.logits, np.asarray(want.logits), **TOL)
    greedy = eng.generate(toks, 6)
    assert not np.array_equal(greedy.tokens, got.tokens)


def test_decode_engine_groups_requests_by_key_as_the_reference(f32):
    """Requests submitted one by one: the two that share a key decode as one
    batch (the reference groups them by the key object), the third, at its
    own key, alone; every row is the JAX engine's."""
    jm, jbank, tcfg, tbank = f32
    ps = prompts(tcfg.vocab_size, [4, 4, 4], seed=2)
    ka, kb = jax.random.PRNGKey(21), jax.random.PRNGKey(22)

    def run(engine, req, keys):
        ids = [engine.submit(req(tokens=p, max_new_tokens=5, key=k))
               for p, k in zip(ps, keys)]
        done = {c.request_id: c for c in engine.drain()}
        return [done[i].tokens for i in ids]

    want = run(JaxDecodeEngine(model=jm, params=jbank, max_seq=16, fused=True),
               JaxRequest, [ka, ka, kb])
    got = run(DecodeEngine(tcfg, tbank, max_seq=16, device="cpu"), Request,
              [np.asarray(ka), _pair(ka), np.asarray(kb)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_bf16_sampled_log_probs_match_jax_loosely():
    """bf16 rounds activations at places that differ between the packages,
    so a sampled stream may part from the reference's: the tokens and the
    log-probs (within 0.1) are compared up to the first step that splits."""
    jm, jbank, tcfg, tbank = _setup("bfloat16")
    toks = np.stack(prompts(tcfg.vocab_size, [6, 6]))
    jk = jax.random.PRNGKey(5)
    want = JaxDecodeEngine(model=jm, params=jbank, max_seq=16, fused=True,
                           return_logits=True).generate(toks, 4, key=jk)
    got = DecodeEngine(tcfg, tbank, max_seq=16, return_logits=True,
                       device="cpu").generate(toks, 4, key=np.asarray(jk))
    want_t, want_l = np.asarray(want.tokens), np.asarray(want.logits)
    for b in range(toks.shape[0]):
        same = np.cumprod(got.tokens[b] == want_t[b])  # steps before a split
        upto = int(same.sum()) + 1                    # + the step that split
        assert upto >= 2  # the first token (drawn after the prefill) agrees
        np.testing.assert_allclose(got.logits[b, :upto], want_l[b, :upto],
                                   rtol=0, atol=0.1)


def _paged(engine_cls, req_cls, model, bank, reqs, **kw):
    """Fill both slots, pump once, then submit the rest (one at a higher
    priority, which preempts a sampled request) and drain."""
    eng = engine_cls(model=model, params=bank, num_slots=2, page_size=8,
                     max_seq=32, decode_chunk=3, return_logits=True, **kw)
    ids, early = [], []
    for i, (toks, n, prio, key) in enumerate(reqs):
        if i == 2:
            early = eng.step()
        ids.append(eng.submit(req_cls(tokens=toks, max_new_tokens=n,
                                      priority=prio, key=key)))
    done = {c.request_id: c for c in early + eng.drain()}
    return eng, [done[i] for i in ids]


def test_paged_engine_samples_the_jax_engines_tokens_through_a_preemption(f32):
    jm, jbank, tcfg, tbank = f32
    ps = prompts(tcfg.vocab_size, [5, 3, 7, 2, 6], seed=4)
    seeds = [None, 32, 33, 34, None]  # the preempted one (1) samples
    budgets = [9, 7, 4, 6, 5]
    prios = [0, 0, 5, 0, 0]
    jreqs = [(p, n, pr, None if s is None else jax.random.PRNGKey(s))
             for p, n, pr, s in zip(ps, budgets, prios, seeds)]
    treqs = [(p, n, pr, None if s is None else (s if i % 2 else
                                                 np.asarray(jax.random.PRNGKey(s))))
             for i, (p, n, pr, s) in enumerate(zip(ps, budgets, prios, seeds))]
    _, want = _paged(JaxPagedEngine, JaxRequest, jm, jbank, jreqs, fused=True)
    eng, got = _paged(PagedDecodeEngine, Request, tcfg, tbank, treqs, device="cpu")
    assert sum(c.timing.get("evictions", 0) for c in got) == 1
    assert sum(c.timing.get("evictions", 0) for c in want) == 1
    for g, w, n in zip(got, want, budgets):
        assert g.status == w.status == "ok" and len(g.tokens) == n
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        np.testing.assert_allclose(g.logits, np.asarray(w.logits), **TOL)
    # the sampled tokens are not the argmax: the draws did something
    assert any(not np.array_equal(g.tokens, np.argmax(g.logits, -1))
               for g, s in zip(got, seeds) if s is not None)
    assert eng.free_pages == eng.num_pages - 1 and eng.num_active == 0
