"""repro_torch.cluster.serve against repro.cluster.serve, on the CPU.

The same numpy-seeded banks and queries go through both packages'
``ServeEngine``: an 8-chain bank of the paper's polynomial regression
(statistics within 1e-6: both reduce in fp32, only the order of a few
float sums differs) and the reduced qwen3-4b in float32 through
``transformer_next_token_predict`` (logits and statistics within 1e-4, the
ROADMAP's logits tolerance: XLA's and ATen's matmuls sum in another
order).  Then the engine's own contracts: bucket padding invisible, the
caller's buffer untouched, one host scratch a rung, tree queries, the
request-level endpoint, degraded serving, checkpoints crossing both
ways, and the bank-form predict fn (a difference by design: the port's
takes the whole bank where the JAX engine vmaps one chain's forward).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import samplers as jsamplers
from repro.cluster import ClusterEngine as JClusterEngine
from repro.cluster import HealthState as JHealthState
from repro.cluster import ServeEngine as JServeEngine
from repro.cluster import predictive_stats as jpredictive_stats
from repro.configs import get_reduced as jax_reduced
from repro.core import PolyRegression as JPolyRegression
from repro.models import mlp_predict as jmlp_predict
from repro.models import regression_predict as jregression_predict
from repro.models import transformer_next_token_predict as jnext_token
from repro.models.mlp import init_mlp as jinit_mlp
from repro.models.transformer import Model as JModel
from repro.models.transformer import init_params as jax_init
from repro.samplers.base import SamplerState as JSamplerState
from repro_torch import samplers
from repro_torch.checkpoint import restore_ensemble
from repro_torch.cluster import (
    ClusterEngine,
    DecodeEngine,
    Request,
    ServeEngine,
    ServeResult,
    bucket_size,
    ensemble_async,
    predictive_stats,
)
from repro_torch.cluster import serve as serve_mod
from repro_torch.cluster.api import FINISH_QUERY, HostScratch
from repro_torch.configs import get_reduced
from repro_torch.core import PolyRegression, WorkerModel
from repro_torch.faults import HealthState
from repro_torch.kernels import rng
from repro_torch.models import (
    mlp_predict,
    regression_predict,
    transformer_next_token_predict,
)
from repro_torch.models.transformer import Model
from repro_torch.obs.metrics import registry
from repro_torch.samplers.base import SamplerState
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401

C = 8
STAT_TOL = dict(rtol=1e-6, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _full_fp32_matmuls():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def regs():
    return (JPolyRegression.make(jax.random.PRNGKey(0)),
            PolyRegression.make(rng.PRNGKey(0), device="cpu"))


@pytest.fixture(scope="module")
def bank():
    """An 8-chain regression bank (C, 5), numpy: both packages take it."""
    return np.random.default_rng(1).standard_normal((C, 5)).astype(np.float32)


def _engine(regs, bank, **kw):
    return ServeEngine(predict_fn=regression_predict(regs[1]),
                       params=torch.from_numpy(bank), device="cpu", **kw)


def _direct(regs, bank, z, qs=(0.05, 0.5, 0.95)):
    """The unpadded reference in the port: every chain's forward over the
    request as it is, then the shared reduction."""
    preds = regression_predict(regs[1])(torch.from_numpy(bank), torch.from_numpy(z))
    return [t.numpy() for t in predictive_stats(preds, torch.tensor(qs))]


def _assert_stats_close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


def _queries(seed, n):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, n).astype(np.float32)


# ---------------------------------------------------------------------------
# the reduction
# ---------------------------------------------------------------------------
def test_predictive_stats_matches_jax():
    preds = np.random.default_rng(0).standard_normal((8, 64, 3)).astype(np.float32)
    qs = (0.05, 0.25, 0.5, 0.95)
    want = jpredictive_stats(jnp.asarray(preds), jnp.asarray(qs, jnp.float32))
    got = predictive_stats(torch.from_numpy(preds), torch.tensor(qs))
    assert got.quantiles.shape == (4, 64, 3)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-6)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), rtol=1e-6)
    np.testing.assert_allclose(got.quantiles.numpy(), np.asarray(want.quantiles),
                               rtol=0, atol=1e-6)


def test_predictive_stats_takes_a_large_block_in_column_chunks(monkeypatch):
    """Above ``torch.quantile``'s element limit the columns are reduced in
    chunks: the same values as one call."""
    preds = torch.from_numpy(
        np.random.default_rng(2).standard_normal((5, 7, 6)).astype(np.float32))
    qs = torch.tensor([0.1, 0.5, 0.9])
    whole = predictive_stats(preds, qs)
    monkeypatch.setattr(serve_mod, "_QUANTILE_MAX", 5 * 4)  # 4 columns a chunk
    chunked = predictive_stats(preds, qs)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_std_is_the_root_of_var_in_either_array_type():
    var = np.array([0.25, 4.0], np.float32)
    assert np.array_equal(ServeResult(var, var, var).std, np.sqrt(var))
    t = torch.from_numpy(var)
    assert torch.equal(ServeResult(t, t, t).std, torch.sqrt(t))


# ---------------------------------------------------------------------------
# the engine against the JAX package's
# ---------------------------------------------------------------------------
def test_serve_engine_matches_jax_over_a_mixed_stream(regs, bank):
    jeng = JServeEngine(predict_fn=jregression_predict(regs[0]), params=jnp.asarray(bank))
    eng = _engine(regs, bank)
    for i, n in enumerate((5, 3, 16, 8)):
        z = _queries(10 + i, n)
        got, want = eng(z), jeng(z)
        assert got.mean.shape == (n,) and got.quantiles.shape == (3, n)
        _assert_stats_close(got, want, **STAT_TOL)


def test_bucket_padding_is_invisible(regs, bank):
    """A request padded up its rung gives every statistic of the same
    request served directly, unpadded, within 1e-6 (not bit for bit: the
    padded rows change the matmul's M, and with it ATen's blocking)."""
    eng = _engine(regs, bank)
    for i, n in enumerate((3, 5, 7, 1, 6)):
        z = _queries(20 + i, n)
        assert bucket_size(n) != n or n == 1
        _assert_stats_close(eng(z), _direct(regs, bank, z), rtol=1e-6, atol=1e-7)


def test_the_callers_buffer_is_never_consumed_or_rewritten(regs, bank):
    eng = _engine(regs, bank)
    for n in (4, 5):  # exactly a rung, and padded up one
        z = _queries(30 + n, n)
        keep = z.copy()
        eng(z)
        assert np.array_equal(z, keep)
        t = torch.from_numpy(z.copy())
        keep_t = t.clone()
        padded = serve_mod._pad_queries(t, 8, scratch=HostScratch(), device=t.device)
        assert torch.equal(t, keep_t) and padded.shape == (8,)
        assert torch.equal(padded[n:], t[-1:].expand(8 - n))
        eng._serve_batch(t)
        assert torch.equal(t, keep_t)
    t = torch.from_numpy(_queries(40, 8))
    assert serve_mod._pad_queries(t, 8, scratch=HostScratch(), device=t.device) is t


def test_host_padding_reuses_one_scratch_per_rung(regs, bank):
    eng = _engine(regs, bank)
    eng(_queries(0, 5))
    assert eng.num_host_pad_allocs == 1  # rung 8's scratch
    buf = eng._scratch.get(("pad", 0), (8,), np.float32)
    for i in range(6):  # the same rung, other sizes: no new buffer
        z = _queries(50 + i, 5 + i % 3)
        _assert_stats_close(eng(z), _direct(regs, bank, z), rtol=1e-6, atol=1e-7)
    assert eng.num_host_pad_allocs == 1
    assert eng._scratch.get(("pad", 0), (8,), np.float32) is buf
    eng(_queries(60, 12))  # rung 16
    assert eng.num_host_pad_allocs == 2
    eng(_queries(61, 8))  # exactly a rung: no scratch
    assert eng.num_host_pad_allocs == 2


def test_host_scratch_pad_edge_replicates_and_passes_a_full_rung_through():
    s = HostScratch()
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    out = s.pad(x, 5, key=1)
    assert np.array_equal(out, np.concatenate([x, x[-1:], x[-1:]]))
    assert s.pad(x, 3) is x and s.allocs == 1


def test_tree_queries_pad_and_slice(regs, bank):
    reg = regs[1]

    def predict(w, batch):
        return regression_predict(reg)(w, batch["z"]) + batch["offset"]

    eng = ServeEngine(predict_fn=predict, params=torch.from_numpy(bank), device="cpu")
    z = _queries(70, 3)
    off = np.array([0.0, 1.0, -2.0], np.float32)
    res = eng({"z": z, "offset": off})
    assert res.mean.shape == (3,) and eng.num_host_pad_allocs == 2  # a scratch a leaf
    want = _direct(regs, bank, z)
    np.testing.assert_allclose(res.mean, want[0] + off, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res.var, want[1], rtol=1e-5, atol=1e-7)


def test_quantile_order_follows_the_engines_quantiles(regs, bank):
    z = _queries(80, 4)
    res = _engine(regs, bank, quantiles=(0.9, 0.1, 0.5))(z)
    low_first = _engine(regs, bank, quantiles=(0.1, 0.5, 0.9))(z)
    assert res.quantiles.shape == (3, 4)
    assert np.array_equal(res.quantiles[[1, 2, 0]], low_first.quantiles)
    assert np.all(res.quantiles[1] <= res.quantiles[2])
    assert np.all(res.quantiles[2] <= res.quantiles[0])
    assert np.all(res.var >= 0) and np.array_equal(res.std, np.sqrt(res.var))


# ---------------------------------------------------------------------------
# the request-level endpoint
# ---------------------------------------------------------------------------
def test_serve_is_bitwise_submit_and_drain(regs, bank):
    z = _queries(90, 5)
    res = _engine(regs, bank).serve(z)
    b = _engine(regs, bank)
    ids = [b.submit(Request(tokens=z[i])) for i in range(5)]
    comps = {c.request_id: c for c in b.drain()}
    rows = [comps[i].stats for i in ids]
    assert all(comps[i].finish_reason == FINISH_QUERY for i in ids)
    assert np.array_equal(np.stack([r.mean for r in rows]), res.mean)
    assert np.array_equal(np.stack([r.var for r in rows]), res.var)
    assert np.array_equal(np.stack([r.quantiles for r in rows], axis=1), res.quantiles)


def test_a_request_with_new_tokens_is_rejected(regs, bank):
    eng = _engine(regs, bank)
    with pytest.raises(ValueError, match="belongs on a decode engine"):
        eng.submit(Request(tokens=np.float32(0.3), max_new_tokens=4))
    assert eng._pending == []


def test_drain_groups_mixed_query_structures(regs, bank):
    """Scalars and 3-vectors in one drain: each structure is one batch, in
    first-submission order, and every request gets its own row."""
    reg = regs[1]

    def predict(w, x):  # a scalar query, or the mean of a 3-vector
        return regression_predict(reg)(w, x if x.dim() == 1 else x.mean(dim=1))

    eng = ServeEngine(predict_fn=predict, params=torch.from_numpy(bank), device="cpu")
    vecs = np.random.default_rng(3).uniform(-1, 1, (2, 3)).astype(np.float32)
    scalars = [np.float32(0.1), np.float32(0.7), np.float32(-0.4)]
    ids = [eng.submit(Request(tokens=scalars[0])), eng.submit(Request(tokens=vecs[0])),
           eng.submit(Request(tokens=scalars[1])), eng.submit(Request(tokens=vecs[1])),
           eng.submit(Request(tokens=scalars[2]))]
    before = registry().counter("serve.requests").value
    comps = {c.request_id: c for c in eng.drain()}
    assert registry().counter("serve.requests").value - before == 2  # two batches
    want_s = _direct(regs, bank, np.array(scalars))
    want_v = _direct(regs, bank, vecs.mean(axis=1))
    for k, i in enumerate((0, 2, 4)):
        np.testing.assert_allclose(comps[ids[i]].stats.mean, want_s[0][k], rtol=1e-6)
    for k, i in enumerate((1, 3)):
        np.testing.assert_allclose(comps[ids[i]].stats.mean, want_v[0][k], rtol=1e-6)


def test_serve_metrics_count_requests_and_queries(regs, bank):
    reg = registry()
    r0, q0 = reg.counter("serve.requests").value, reg.counter("serve.queries").value
    eng = _engine(regs, bank)
    eng(_queries(95, 3))
    eng(_queries(96, 5))
    assert reg.counter("serve.requests").value - r0 == 2
    assert reg.counter("serve.queries").value - q0 == 8
    assert reg.gauge("serve.bucket_utilization").value == 5 / 8
    assert "serve.request_ms" in reg.snapshot()


# ---------------------------------------------------------------------------
# constructors: degraded serving and checkpoints
# ---------------------------------------------------------------------------
def test_from_cluster_serves_degraded_from_a_health_state(regs, bank):
    bad = bank.copy()
    bad[2] = np.nan
    health = np.array([True, True, False] + [True] * (C - 3))
    jhs = JHealthState(JSamplerState(jnp.asarray(bad), jnp.zeros(C, jnp.int32),
                                     jax.random.split(jax.random.PRNGKey(1), C), ()),
                       jnp.asarray(health))
    hs = HealthState(SamplerState(torch.from_numpy(bad), 0, rng.split((0, 1), C), ()),
                     health)
    z = _queries(100, 6)
    want = JServeEngine.from_cluster(jhs, jregression_predict(regs[0]))(z)
    eng = ServeEngine.from_cluster(hs, regression_predict(regs[1]), device="cpu")
    assert eng.num_chains == C - 1
    got = eng(z)
    assert np.isfinite(got.mean).all()
    _assert_stats_close(got, want, **STAT_TOL)
    with pytest.raises(ValueError, match="every chain is quarantined"):
        ServeEngine.from_cluster(HealthState(hs.state, np.zeros(C, bool)),
                                 regression_predict(regs[1]), device="cpu")


def _key(gen):
    """A JAX-style key drawn from the run's ``torch.Generator`` (the port's
    ``batch_fn`` takes a generator, ``PolyRegression.sample_batch`` a key)."""
    return rng.PRNGKey(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))


def _trained_banks(regs):
    """12 commits of an 8-chain W-Con ensemble in each package."""
    jreg, reg = regs
    scheds = ensemble_async(WorkerModel(num_workers=4, seed=1), 12, C, seed=0)
    tau = max(max(s.max_delay for s in scheds), 1)
    s = samplers.sgld("consistent", lambda w, b: reg.grad(w, b), gamma=1e-4,
                      sigma=1e-3, tau=tau)
    eng = ClusterEngine(s, num_chains=C, chunk_size=6,
                        batch_fn=lambda g: reg.sample_batch(_key(g), 32))
    state, _ = eng.run(eng.init(torch.zeros(5), rng.PRNGKey(3), jitter=0.1),
                       steps=12, schedule=scheds, key=4)
    js = jsamplers.sgld("consistent", lambda w, b: jreg.grad(w, b), gamma=1e-4,
                        sigma=1e-3, tau=tau)
    jeng = JClusterEngine(js, num_chains=C, chunk_size=6,
                          batch_fn=lambda k: jreg.sample_batch(k, 32))
    jstate, _ = jeng.run(jeng.init(jnp.zeros(5), jax.random.PRNGKey(3), jitter=0.1),
                         steps=12, schedule=scheds, key=jax.random.PRNGKey(4))
    return (eng, state), (jeng, jstate)


def test_from_checkpoint_takes_both_orders_and_files_cross_both_ways(regs, tmp_path):
    (eng, state), (jeng, jstate) = _trained_banks(regs)
    z = _queries(110, 6)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    eng.save_ensemble(state, mine)
    jeng.save_ensemble(jstate, theirs)
    fn = regression_predict(regs[1])
    live = ServeEngine.from_cluster(state, fn, device="cpu")
    for path, want_bank in ((mine, state.params.numpy()),
                            (theirs, np.array(jstate.params))):
        want = _direct(regs, want_bank, z)
        for srv in (ServeEngine.from_checkpoint(path, torch.zeros(5), fn, device="cpu"),
                    ServeEngine.from_checkpoint(path, fn, torch.zeros(5), device="cpu"),
                    ServeEngine.from_checkpoint(path, like=torch.zeros(5), predict_fn=fn,
                                                device="cpu")):
            assert srv.num_chains == C
            _assert_stats_close(srv(z), want, rtol=1e-6, atol=1e-7)
    _assert_stats_close(ServeEngine.from_checkpoint(mine, torch.zeros(5), fn,
                                                    device="cpu")(z), live(z),
                        rtol=0, atol=0)
    # the port's file in the JAX engine, against the JAX engine on that bank
    jfn = jregression_predict(regs[0])
    got = JServeEngine.from_checkpoint(mine, like=jnp.zeros(5), predict_fn=jfn)(z)
    want = JServeEngine(predict_fn=jfn, params=jnp.asarray(state.params.numpy()))(z)
    _assert_stats_close(got, want, rtol=0, atol=0)
    assert restore_ensemble(theirs, torch.zeros(5)).shape == (C, 5)


def test_serve_engine_needs_a_card_unless_asked_for_the_cpu(regs, bank, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(predict_fn=regression_predict(regs[1]), params=torch.from_numpy(bank))
    _engine(regs, bank)


# ---------------------------------------------------------------------------
# the predict fns: bank-form, against the JAX builders vmapped over the bank
# ---------------------------------------------------------------------------
def test_predict_fns_are_bank_form(regs, bank):
    """The port's PredictFn takes the whole bank, ``(C, ...)`` params, and
    returns ``(C, Q, ...)``; the JAX builders return one chain's forward,
    which the JAX engine vmaps — the two agree chain for chain.  A one-chain
    forward handed to the port's engine is refused."""
    jreg, reg = regs
    z = _queries(120, 7)
    got = regression_predict(reg)(torch.from_numpy(bank), torch.from_numpy(z))
    want = jax.vmap(jregression_predict(jreg), in_axes=(0, None))(jnp.asarray(bank), z)
    assert got.shape == (C, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STAT_TOL)

    def one_chain(w, q):  # the JAX contract: (Q,) from one chain
        return reg.predict(w[0], reg.features(q))

    eng = ServeEngine(predict_fn=one_chain, params=torch.from_numpy(bank), device="cpu")
    with pytest.raises(ValueError, match="bank-form predict fn"):
        eng(z)


def test_mlp_predict_matches_jax():
    jcfg = replace(jax_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    jbank = jax.vmap(lambda k: jinit_mlp(k, jcfg, jnp.float32))(jax.random.split(jax.random.PRNGKey(2), 3))
    tbank = from_jax_params(jax.tree_util.tree_map(np.asarray, jbank), device="cpu")
    x = np.random.default_rng(4).standard_normal((5, jcfg.d_model)).astype(np.float32)
    want = JServeEngine(predict_fn=jmlp_predict(jcfg), params=jbank, donate=False)(x)
    got = ServeEngine(predict_fn=mlp_predict(tcfg), params=tbank, device="cpu")(x)
    assert got.mean.shape == (5, tcfg.d_model)
    _assert_stats_close(got, want, **LOGIT_TOL)


@pytest.fixture(scope="module")
def lm():
    """The reduced qwen3-4b in float32, a bank of 2 chains drawn by the JAX
    init and carried over."""
    jcfg = replace(jax_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    jbank = jax.vmap(lambda k: jax_init(k, jcfg))(jax.random.split(jax.random.PRNGKey(0), 2))
    tbank = from_jax_params(jax.tree_util.tree_map(np.asarray, jbank), device="cpu")
    return jcfg, tcfg, jbank, tbank


def test_next_token_serving_matches_jax(lm):
    """3 prompts x 8 tokens: the per-chain logits through ``Model.prefill``
    and the engine's statistics against the JAX engine's, within 1e-4."""
    jcfg, tcfg, jbank, tbank = lm
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    jpredict = jnext_token(JModel(jcfg, remat=False))
    predict = transformer_next_token_predict(Model(tcfg, device="cpu"))
    with torch.no_grad():
        per_chain = predict(tbank, {"tokens": toks})
    want_pc = jax.vmap(jpredict, in_axes=(0, None))(jbank, {"tokens": toks})
    assert per_chain.shape == (2, 3, tcfg.vocab_size) and per_chain.dtype == torch.float32
    np.testing.assert_allclose(per_chain.numpy(), np.asarray(want_pc), **LOGIT_TOL)
    want = JServeEngine(predict_fn=jpredict, params=jbank, quantiles=(0.1, 0.9),
                        donate=False)({"tokens": toks})
    got = ServeEngine(predict_fn=predict, params=tbank, quantiles=(0.1, 0.9),
                      device="cpu")({"tokens": toks})
    assert got.quantiles.shape == (2, 3, tcfg.vocab_size)
    _assert_stats_close(got, want, **LOGIT_TOL)
    np.testing.assert_allclose(got.mean, per_chain.mean(dim=0).numpy(), rtol=1e-6)


def test_decoder_streams_the_same_tokens_as_a_decode_engine(lm):
    _, tcfg, _, tbank = lm
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    srv = ServeEngine(predict_fn=transformer_next_token_predict(Model(tcfg, device="cpu")),
                      params=tbank, device="cpu")
    dec = srv.decoder(tcfg, max_seq=32)
    assert isinstance(dec, DecodeEngine) and dec.params is srv.params
    want = DecodeEngine(tcfg, tbank, max_seq=32, device="cpu").generate(toks, 4)
    assert np.array_equal(dec.generate(toks, 4).tokens, want.tokens)
