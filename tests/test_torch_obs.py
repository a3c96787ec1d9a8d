"""repro_torch.obs against repro.obs: the span tracer's ``trace_hook`` as a
hook of the port's ``Engine`` and ``ClusterEngine``, and the Chrome-trace
timelines (the twin of ``tests/test_obs.py``).

``cluster_timeline``, ``decode_timeline``, ``paged_timeline`` and
``summarize`` are copies of the reference's: on the same schedules and
span lists they give the reference's JSON exactly.  The live timelines
come from the port's engines on the CPU (the reduced qwen3-4b, float32),
and a traced warm decode stream keeps ``stream_flags()`` empty.
"""

import json
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.cluster import WorkerSchedule as JaxWorkerSchedule
from repro.obs import timeline as jax_timeline
from repro_torch import samplers
from repro_torch.analysis import instrument
from repro_torch.cluster import (
    ClusterEngine,
    DecodeEngine,
    PagedDecodeEngine,
    Request,
    WorkerSchedule,
    ensemble_async,
)
from repro_torch.configs import get_reduced
from repro_torch.core import FaultPlan, Quadratic, WorkerModel
from repro_torch.kernels import rng
from repro_torch.models.transformer import init_params
from repro_torch.obs.metrics import Registry
from repro_torch.obs.timeline import (
    cluster_timeline,
    decode_timeline,
    paged_timeline,
    summarize,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.trace import Tracer, span, trace_hook, tracer
from repro_torch.train.engine import Engine
from torch_cases import one_cpu_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


# ---------------------------------------------------------------------------
# span tracer and trace_hook
# ---------------------------------------------------------------------------
def test_disabled_span_is_shared_noop_context():
    tr = tracer()
    assert not tr.enabled  # global tracer starts disabled
    ctx1, ctx2 = span("a"), span("b", attr=1)
    assert ctx1 is ctx2
    with ctx1 as sp:
        sp.set(ignored=True)
    assert tr.spans == []


def test_spans_nest_with_parent_links_across_instrument_regions():
    tr = Tracer(enabled=True)
    with instrument():
        with tr.span("outer", level=0) as outer:
            with instrument():
                with tr.span("inner", level=1) as inner:
                    pass
            with tr.span("sibling"):
                pass
    spans = {sp.name: sp for sp in tr.spans}
    assert spans["inner"].parent_id == outer.span_id
    assert spans["sibling"].parent_id == outer.span_id
    assert spans["outer"].parent_id is None
    assert inner.t0 >= outer.t0 and inner.t1 <= spans["outer"].t1


def test_trace_hook_emits_one_span_per_chunk_boundary():
    tr = Tracer(enabled=True)
    hook = trace_hook(to=tr)
    hook(50, None, None)
    hook(100, None, None)
    spans = tr.spans
    assert [sp.attrs for sp in spans] == [{"start": 0, "end": 50},
                                          {"start": 50, "end": 100}]
    assert spans[0].t1 <= spans[1].t0
    assert all(sp.name == "engine.chunk" for sp in spans)


def _quad_sampler(fused=False):
    q = Quadratic.make(rng.PRNGKey(0), d=4, m=1.0, L=3.0, device="cpu")
    return samplers.sgld("inconsistent", lambda p, b: q.grad(p, b), gamma=0.01,
                         sigma=0.5, tau=2, fused=fused)


@pytest.mark.parametrize("engine", ["Engine", "ClusterEngine"])
def test_trace_hook_on_the_engines_spans_each_chunk(engine):
    """Wired as a hook, ``trace_hook`` gives one ``engine.chunk`` span a
    chunk, carrying the commit range, on either engine."""
    tr = Tracer(enabled=True)
    s = _quad_sampler()
    if engine == "Engine":
        eng = Engine(s, chunk_size=3, hooks=[trace_hook(to=tr)])
        eng.run(s.init(torch.zeros(4), rng.PRNGKey(1)), steps=7,
                batches=torch.zeros(7, 1), delays=np.zeros(7, np.int32))
    else:
        eng = ClusterEngine(s, num_chains=3, chunk_size=3, hooks=[trace_hook(to=tr)])
        eng.run(eng.init(torch.zeros(4), rng.PRNGKey(1)), steps=7,
                schedule=ensemble_async(WorkerModel(num_workers=2), 7, 3, seed=0))
    spans = tr.spans
    assert [sp.name for sp in spans] == ["engine.chunk"] * 3
    assert [(sp.attrs["start"], sp.attrs["end"]) for sp in spans] == [(0, 3), (3, 6), (6, 7)]
    assert all(a.t1 <= b.t0 for a, b in zip(spans, spans[1:]))


# ---------------------------------------------------------------------------
# timelines: the reference's JSON on the same input
# ---------------------------------------------------------------------------
def _schedules(faults: bool):
    model = WorkerModel(num_workers=3, faults=FaultPlan(crash_rate=0.2, mean_downtime=2.0)
                        if faults else None)
    return ensemble_async(model, 24, 3, seed=5, batch_policy="inverse-speed",
                          base_batch=8)


def _as_jax(s: WorkerSchedule) -> JaxWorkerSchedule:
    return JaxWorkerSchedule(read_versions=s.read_versions, worker_ids=s.worker_ids,
                             commit_times=s.commit_times, num_workers=s.num_workers,
                             batch_sizes=s.batch_sizes, alive=s.alive)


@pytest.mark.parametrize("faults", [False, True], ids=["fault-free", "chaos"])
@pytest.mark.parametrize("max_chains", [None, 2])
def test_cluster_timeline_json_equals_the_references(faults, max_chains):
    scheds = _schedules(faults)
    if faults:
        assert any(s.alive is not None and not s.alive.all() for s in scheds)
    got = cluster_timeline(scheds, max_chains=max_chains, time_scale=0.5)
    want = jax_timeline.cluster_timeline([_as_jax(s) for s in scheds],
                                         max_chains=max_chains, time_scale=0.5)
    assert validate_chrome_trace(got) == []
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert summarize(got) == jax_timeline.summarize(want)


def test_cluster_timeline_carries_staleness():
    k = np.arange(6)
    sched = WorkerSchedule(read_versions=np.maximum(k - 2, 0).astype(np.int32),
                           worker_ids=(k % 2).astype(np.int32),
                           commit_times=(0.5 + 0.5 * k).astype(np.float64),
                           num_workers=2, batch_sizes=np.full(6, 8, np.int32))
    trace = cluster_timeline([sched, sched], max_chains=1)
    commits = {ev["args"]["commit"]: ev for ev in trace["traceEvents"]
               if ev.get("ph") == "X"}
    assert len(commits) == 6
    assert commits[5]["args"]["staleness"] == 2
    assert commits[5]["tid"] == 1
    assert commits[5]["ts"] == pytest.approx(2.0e6)
    assert summarize(cluster_timeline(sched))["staleness_hist"] == {0: 1, 1: 1, 2: 4}


DECODE_SPANS = [{"name": "decode.generate", "id": 7, "parent": None,
                 "t0": 1.0, "t1": 2.0, "tid": 123,
                 "attrs": {"B": 3, "T": 5, "b_rung": 4, "t_rung": 8,
                           "new_tokens": 2, "chains": 4}}]
PAGED_SPANS = [
    {"name": "paged.admit", "id": 1, "parent": None, "t0": 1.0, "t1": 1.2,
     "tid": 9, "attrs": {"slot": 0, "request_id": 41, "T": 5, "t_rung": 8, "pages": 2}},
    {"name": "paged.admit", "id": 2, "parent": None, "t0": 2.0, "t1": 2.1,
     "tid": 9, "attrs": {"slot": 1, "request_id": 41, "T": 5, "t_rung": 8, "pages": 2}},
    {"name": "paged.decode_chunk", "id": 3, "parent": None, "t0": 1.2,
     "t1": 1.5, "tid": 9, "attrs": {"active": 2, "chunk": 4}},
    {"name": "paged.request", "id": 4, "parent": None, "t0": 0.5, "t1": 2.5,
     "tid": 9, "attrs": {"slot": 1, "request_id": 41, "new_tokens": 6, "evictions": 1}},
]


@pytest.mark.parametrize("which", ["decode", "paged", "spans"])
def test_span_timelines_equal_the_references(which):
    fn, spans = {"decode": ("decode_timeline", DECODE_SPANS),
                 "paged": ("paged_timeline", PAGED_SPANS),
                 "spans": ("to_chrome_trace", PAGED_SPANS + DECODE_SPANS)}[which]
    got = {"decode_timeline": decode_timeline, "paged_timeline": paged_timeline,
           "to_chrome_trace": to_chrome_trace}[fn](spans)
    want = getattr(jax_timeline, fn)(spans)
    assert validate_chrome_trace(got) == []
    assert got == want
    assert summarize(got) == jax_timeline.summarize(want)


def test_decode_timeline_amortizes_token_slices():
    trace = decode_timeline(DECODE_SPANS)
    evs = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"]
    assert [ev["name"] for ev in evs] == ["decode.generate", "decode.prefill",
                                         "decode.token", "decode.token"]
    assert evs[1]["dur"] == pytest.approx(8 * 1e6 / 10)
    assert all(ev["args"]["request_span"] == 7 for ev in evs[1:])


def test_paged_timeline_queue_wait_and_scheduler_row():
    evs = {ev["name"]: ev for ev in paged_timeline(PAGED_SPANS)["traceEvents"]
           if ev.get("ph") == "X"}
    assert evs["paged.wait"]["ts"] == pytest.approx(0.5e6)
    assert evs["paged.wait"]["tid"] == 0
    assert evs["paged.request"]["tid"] == 1
    assert evs["paged.decode_chunk"]["tid"] == 2


# ---------------------------------------------------------------------------
# live engines on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bank():
    cfg = replace(get_reduced("qwen3-4b"), dtype="float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                            num_chains=2)


def test_paged_timeline_from_live_engine(bank):
    """The spans a live PagedDecodeEngine records carry every attribute the
    timeline reads: one admit, one wait and one residency per request."""
    cfg, params = bank
    tr = tracer().enable()
    tr.clear()
    try:
        eng = PagedDecodeEngine(cfg, params, num_slots=2, page_size=8, max_seq=32,
                                decode_chunk=4, device="cpu")
        r = np.random.default_rng(0)
        for t, n in [(5, 4), (3, 2), (6, 5)]:
            eng.submit(Request(tokens=r.integers(0, cfg.vocab_size, (t,)).astype(np.int32),
                               max_new_tokens=n))
        comps = eng.drain()
        spans = tr.drain()
    finally:
        tr.disable()
    trace = paged_timeline(spans)
    assert validate_chrome_trace(trace) == []
    assert trace == jax_timeline.paged_timeline([sp.to_dict() for sp in spans])
    evs = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"]
    by = lambda n: [ev for ev in evs if ev["name"] == n]  # noqa: E731
    assert len(by("paged.request")) == len(comps) == 3
    assert len(by("paged.admit")) == len(by("paged.wait")) == 3
    assert len(by("paged.decode_chunk")) >= 1
    assert {ev["args"]["new_tokens"] for ev in by("paged.request")} == {4, 2, 5}


def test_traced_warm_decode_stream_keeps_stream_flags_empty(bank):
    cfg, params = bank
    eng = DecodeEngine(cfg, params, max_seq=32, device="cpu")
    prompt = np.zeros((2, 4), np.int32)
    eng.generate(prompt, 3)  # warm the (rung, max_new) rung
    tr = tracer()
    tr.clear()
    tr.enable()
    try:
        with instrument() as rep:
            for _ in range(3):
                eng.generate(prompt, 3)
    finally:
        tr.disable()
    assert rep.stream_flags() == {"retraced_in_stream": False,
                                  "pad_allocs_in_stream": 0}
    spans = [sp for sp in tr.drain() if sp.name == "decode.generate"]
    assert len(spans) == 3 and spans[0].attrs["new_tokens"] == 3
    trace = decode_timeline(spans)
    assert validate_chrome_trace(trace) == []
    assert sum(ev["name"] == "decode.token" for ev in trace["traceEvents"]) == 9


def test_write_chrome_trace_and_summarize_roundtrip(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("a", k=1):
        with tr.span("b"):
            pass
    trace = write_chrome_trace(tmp_path / "t.json", tr.spans)
    assert validate_chrome_trace(trace) == []
    reread = json.loads((tmp_path / "t.json").read_text())
    assert reread == trace
    s = summarize(reread)
    assert s["makespan_s"] > 0 and s["critical"] is not None
    with pytest.raises(ValueError):
        write_chrome_trace(tmp_path / "bad.json", {"not_a_trace": 1})


# ---------------------------------------------------------------------------
# torch_obstool CLI
# ---------------------------------------------------------------------------
def test_torch_obstool_cli_smoke(tmp_path, capsys):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import torch_obstool
    finally:
        sys.path.pop(0)
    write_chrome_trace(tmp_path / "t.json", cluster_timeline(_schedules(False)))
    reg = Registry()
    reg.counter("cluster.commits", "").inc(6)
    reg.histogram("lat", (1.0, 10.0)).observe_many([0.5, 5.0])
    reg.write_snapshot(tmp_path / "m.json")
    rc = torch_obstool.main([str(tmp_path / "t.json"), "--metrics", str(tmp_path / "m.json")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "critical path" in out and "staleness over commit spans" in out
    assert "cluster.commits" in out and "p99<=10" in out
    (tmp_path / "bad.json").write_text('{"traceEvents": [{"ph": "Z"}]}')
    assert torch_obstool.main([str(tmp_path / "bad.json")]) == 1
