"""repro_torch.analysis.instrument against repro.analysis.instrument: the
twins of the five instrument cases of ``tests/test_analysis.py``, and the
engines' counter handles.

A warm mixed serve / decode stream (and a warm paged stream) reports no
new rung and no pad allocation, and its cold run reports per (engine,
program) exactly what the reference's cold run reports: the port traces
nothing, and an engine's first sight of a shape rung stands in for the
reference's jit trace.  ``transfer_guard`` sets
``torch.cuda.set_sync_debug_mode``; without a card it does nothing (a
host read inside the region passes here), and on the card it turns a
host sync into an error (``tests/test_torch_kernels_cuda.py``).
"""

import json
import warnings
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.analysis.instrument import instrument as jax_instrument_fn
from repro.cluster import DecodeEngine as JaxDecodeEngine
from repro.cluster import PagedDecodeEngine as JaxPagedEngine
from repro.cluster import ServeEngine as JaxServeEngine
from repro.cluster.api import Request as JaxRequest
from repro.configs import get_reduced as jax_reduced
from repro.core import PolyRegression as JaxPolyRegression
from repro.models import regression_predict as jax_regression_predict
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import init_params as jax_init
from repro_torch import samplers
from repro_torch.analysis import counters, instrument, record_build
from repro_torch.cluster import (
    ClusterEngine,
    DecodeEngine,
    PagedDecodeEngine,
    Request,
    ServeEngine,
    bucket_size,
)
from repro_torch.configs import get_reduced
from repro_torch.core import PolyRegression, Quadratic
from repro_torch.kernels import rng
from repro_torch.models.predictive import regression_predict
from repro_torch.obs.metrics import registry
from repro_torch.train.engine import Engine
from repro_torch.weights import from_jax_params
from torch_cases import one_cpu_thread  # noqa: F401


def test_counters_broadcast_and_nesting():
    c = counters("X")
    with instrument() as outer:
        c.trace("f")
        with instrument() as inner:
            c.trace("f")
            c.pad_alloc()
    c.trace("g")  # outside both regions: the handle counts it, reports don't
    assert (c.traces, c.pad_allocs) == (3, 1)
    assert c.per_fn == {"f": 2, "g": 1}
    assert outer.num_traces == 2 and inner.num_traces == 1
    assert outer.traces == {("X", "f"): 2}
    assert inner.pad_allocs == {"X": 1} and outer.num_pad_allocs == 1
    assert inner.stream_flags() == {"retraced_in_stream": True,
                                    "pad_allocs_in_stream": 1}
    with instrument() as rep:
        pass
    assert rep.stream_flags() == {"retraced_in_stream": False,
                                  "pad_allocs_in_stream": 0}


def test_nested_regions_that_saw_the_same_events_stay_apart():
    """Regions are told apart by identity: an inner region that saw what
    its outer one saw (nothing, here) leaves the right one on exit."""
    c = counters("Y")
    with instrument() as outer:
        with instrument() as inner:
            pass
        c.trace("f")
    assert outer.traces == {("Y", "f"): 1} and inner.traces == {}


def test_stream_flags_keep_the_references_field_names():
    with instrument() as rep, jax_instrument_fn() as jrep:
        pass
    assert rep.stream_flags() == jrep.stream_flags()


def test_report_to_dict_is_json_ready_with_kernel_builds():
    """``to_dict`` keeps the reference's keys, ``kernel_builds`` in place of
    ``xla_compiles``; a kernel build's wall time lands per library in the
    report and in the registry."""
    c = counters("Eng")
    with instrument() as rep:
        c.trace("stats")
        c.pad_alloc()
        record_build("libtest", 0.25)
    d = json.loads(json.dumps(rep.to_dict()))
    assert d["traces"] == {"Eng/stats": 1}
    assert d["pad_allocs"] == {"Eng": 1}
    assert set(d) == {"traces", "pad_allocs", "kernel_builds", "compile_ms",
                      "donation_warnings", "sync_warnings"}
    assert d["kernel_builds"] == 1 and d["compile_ms"] == {"libtest": 250.0}
    assert rep.compile_time_ms == pytest.approx(250.0)
    assert registry().gauge("kernel.build_ms/libtest").value >= 250.0
    assert registry().counter("kernel.build_ms_total").value >= 250.0


def test_donation_warnings_captured_others_reemitted():
    with pytest.warns(UserWarning, match="unrelated"):
        with instrument() as rep:
            warnings.warn("Some donated buffers were not usable: f32[3]")
            warnings.warn("unrelated warning", UserWarning)
    assert len(rep.donation_warnings) == 1
    assert "donated" in rep.donation_warnings[0]


def test_transfer_guard_is_a_no_op_without_a_card():
    """Without a card there is nothing to synchronise with: a host read in
    an ``"error"`` region passes (on the card it raises — the ``cuda``
    test), and an unknown guard is refused."""
    x = torch.arange(4.0)
    with instrument(transfer_guard="error"):
        assert x[1].item() == 1.0
    with instrument(transfer_guard="error"):
        with instrument(transfer_guard="warn") as rep:
            x.sum().item()
    assert rep.sync_warnings == []
    with pytest.raises(ValueError, match="transfer_guard"):
        with instrument(transfer_guard="disallow"):  # jax's name, not torch's
            pass


# ---------------------------------------------------------------------------
# the engines' counter handles
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def banks():
    jcfg = replace(jax_reduced("qwen3-4b"), dtype="float32")
    tcfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    jbank = jax.vmap(lambda k: jax_init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(2), 2))
    tbank = from_jax_params(jax.tree_util.tree_map(np.asarray, jbank), device="cpu")
    jreg = JaxPolyRegression.make(jax.random.PRNGKey(0))
    treg = PolyRegression.make(rng.PRNGKey(0), device="cpu")
    sbank = np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32)
    return jcfg, jbank, tcfg, tbank, jreg, treg, sbank


def test_mixed_serve_decode_stream_trace_counts(banks):
    """A cold mixed serve + decode stream meets each shape rung once and
    allocates one pad scratch a rung — per (engine, program) exactly as the
    reference's cold stream traces — and replaying it warm is silent."""
    jcfg, jbank, tcfg, tbank, jreg, treg, sbank = banks
    serve = ServeEngine(predict_fn=regression_predict(treg),
                        params=torch.from_numpy(sbank), device="cpu")
    decode = DecodeEngine(tcfg, tbank, max_seq=32, device="cpu")
    jserve = JaxServeEngine(predict_fn=jax_regression_predict(jreg),
                            params=jax.numpy.asarray(sbank))
    jdecode = JaxDecodeEngine(model=JaxModel(jcfg, remat=False), params=jbank, max_seq=32)

    r = np.random.default_rng(0)
    queries = [r.uniform(-1, 1, n).astype(np.float32) for n in (3, 5, 3, 17, 6)]
    shapes = ((2, 5), (3, 5), (2, 9), (2, 5))
    prompts = [r.integers(0, tcfg.vocab_size, s, dtype=np.int32) for s in shapes]
    serve_rungs = {bucket_size(q.size) for q in queries}
    decode_rungs = {(bucket_size(b), bucket_size(t)) for b, t in shapes}

    def replay(serve, decode):
        for q in queries:
            serve(q)
        for p in prompts:
            decode.generate(p, 4)

    with instrument() as cold, jax_instrument_fn() as jcold:
        replay(serve, decode)
        replay(jserve, jdecode)
    assert cold.traces == {("ServeEngine", "stats"): len(serve_rungs),
                           ("DecodeEngine", "decode"): len(decode_rungs)}
    assert cold.traces == jcold.traces
    assert cold.pad_allocs == jcold.pad_allocs == {
        "ServeEngine": len(serve_rungs), "DecodeEngine": len(decode_rungs)}
    assert serve.num_traces == cold.traces_for("ServeEngine")
    assert decode.num_traces == cold.traces_for("DecodeEngine")
    assert serve.num_host_pad_allocs == len(serve_rungs)
    assert decode.num_host_pad_allocs == len(decode_rungs)

    with instrument() as warm:
        replay(serve, decode)
    assert warm.stream_flags() == {"retraced_in_stream": False,
                                   "pad_allocs_in_stream": 0}
    assert warm.traces == {} and warm.to_dict()["pad_allocs"] == {}


def test_paged_stream_trace_counts_match_the_reference(banks):
    """Paged: one first sight a prompt-length rung for the prefill, one for
    the step (slot churn never changes a shape), as the reference traces;
    a warm stream with other prompts on the same rungs is silent."""
    jcfg, jbank, tcfg, tbank, *_ = banks
    eng = PagedDecodeEngine(tcfg, tbank, num_slots=2, page_size=8, max_seq=32,
                            decode_chunk=4, device="cpu")
    jeng = JaxPagedEngine(model=JaxModel(jcfg, remat=False), params=jbank,
                          num_slots=2, page_size=8, max_seq=32, decode_chunk=4)
    r = np.random.default_rng(3)

    def stream(lens):
        return [(r.integers(0, tcfg.vocab_size, (t,)).astype(np.int32), n)
                for t, n in zip(lens, (4, 2, 5, 3))]

    cold = stream((5, 3, 9, 6))
    with instrument() as rep, jax_instrument_fn() as jrep:
        for e, req in ((eng, Request), (jeng, JaxRequest)):
            for p, n in cold:
                e.submit(req(tokens=p, max_new_tokens=n))
            e.drain()
    assert rep.traces == jrep.traces == {("PagedDecodeEngine", "paged_prefill"): 3,
                                         ("PagedDecodeEngine", "paged_step"): 1}
    assert rep.pad_allocs == jrep.pad_allocs
    with instrument() as warm:
        for p, n in stream((7, 4, 12, 3)):
            eng.submit(Request(tokens=p, max_new_tokens=n))
        eng.drain()
    assert warm.stream_flags() == {"retraced_in_stream": False,
                                   "pad_allocs_in_stream": 0}
    assert eng.num_traces == 4


def test_training_engines_report_chunk_layouts():
    """``Engine`` and ``ClusterEngine`` count through their handles: one
    event a new chunk length (layout), the public ``num_traces`` a view."""
    q = Quadratic.make(rng.PRNGKey(0), d=4, m=1.0, L=3.0, device="cpu")
    s = samplers.sgld("consistent", lambda p, b: q.grad(p, b), gamma=0.01,
                      sigma=0.5, tau=2)
    eng = Engine(s, chunk_size=3)
    cl = ClusterEngine(s, num_chains=2, chunk_size=3)
    with instrument() as rep:
        eng.run(s.init(torch.zeros(4), rng.PRNGKey(1)), steps=7,
                batches=torch.zeros(7, 1))
        cl.run(cl.init(torch.zeros(4), rng.PRNGKey(1)), steps=7)
    assert rep.traces == {("Engine", "chunk"): 2, ("ClusterEngine", "chunk[shared]"): 2}
    assert eng.num_traces == 2 and cl.num_traces == 2
    with instrument() as warm:
        eng.run(s.init(torch.zeros(4), rng.PRNGKey(2)), steps=6,
                batches=torch.zeros(6, 1))
    assert warm.stream_flags()["retraced_in_stream"] is False
