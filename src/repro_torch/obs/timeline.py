"""Chrome-trace-event export: spans and schedules as Perfetto timelines (a
copy of ``repro.obs.timeline``).

Everything here emits the JSON object format Perfetto and
``chrome://tracing`` open directly — ``{"traceEvents": [...]}`` with
complete (``"ph": "X"``) duration events in microseconds and ``"M"``
metadata records naming the process/thread rows.  Three producers:

- :func:`to_chrome_trace` — any list of :class:`repro_torch.obs.trace.Span`
  records (or their dicts), one timeline row per originating thread;
- :func:`cluster_timeline` — a :class:`ClusterEngine` run's per-worker
  commit schedule: one process per chain, one row per worker, one span per
  commit stretching from that worker's previous commit to this one on the
  *simulated* wall clock, annotated with the commit index, read version,
  **staleness**, and batch size.  This is the paper's Figure-1 execution
  diagram, reconstructed from the same ``WorkerSchedule`` arrays the
  executor scans — no extra event collection;
- :func:`paged_timeline` — a :class:`PagedDecodeEngine` stream: one row per
  serving *slot* carrying each request's queue wait (submit → admission),
  its prefill (``paged.admit``), and its residency (``paged.request``,
  annotated with new-token count and eviction count), plus a scheduler row
  of ``paged.decode_chunk`` spans showing how many slots each fused step
  chunk advanced.  Continuous batching is visible at a glance: slot rows
  stay dense while the waiting queue drains, and an evicted request shows
  up twice on (possibly) different slot rows;
- :func:`decode_timeline` — a :class:`DecodeEngine` request stream traced by
  :mod:`repro_torch.obs.trace`: per request, one ``decode.generate`` span (the
  host-measured truth) plus **amortized** prefill/per-token child slices on
  the request's bucket-rung row.  The token loop keeps its tokens on the
  device until the generation ends — the host sees no token boundary
  without a sync a step — so each token slice is the request duration
  split position-proportionally (prefill weighs ``t_rung`` cached
  positions, each token one) and carries ``"amortized": true``.

Times: span input is seconds on the :func:`repro_torch.obs.trace.now` clock;
schedule input is simulated seconds; both scale to integer-friendly
microseconds in the output.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Optional, Sequence

from repro_torch.obs.trace import iter_spans

__all__ = ["cluster_timeline", "decode_timeline", "paged_timeline",
           "to_chrome_trace", "write_chrome_trace"]

_US = 1e6


def _meta(pid: int, name: str, tid: Optional[int] = None) -> dict:
    ev = {"ph": "M", "pid": pid, "ts": 0,
          "name": "process_name" if tid is None else "thread_name",
          "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _event(name: str, t0_s: float, t1_s: float, pid: int, tid: int,
           args: dict, cat: str = "repro") -> dict:
    return {"ph": "X", "name": name, "cat": cat, "pid": pid, "tid": tid,
            "ts": round(t0_s * _US, 3),
            "dur": round(max(t1_s - t0_s, 0.0) * _US, 3), "args": args}


def to_chrome_trace(spans, *, pid: int = 0,
                    process_name: str = "repro") -> dict:
    """Spans (objects or dicts) → a Chrome-trace JSON object, one timeline
    row per originating thread, span attributes as ``args`` (parent links
    ride along as ``args["span_id"]/["parent_id"]``)."""
    events = [_meta(pid, process_name)]
    tids: dict = {}
    for sp in iter_spans(spans):
        tid = tids.setdefault(sp["tid"], len(tids))
        args = dict(sp["attrs"])
        args["span_id"] = sp["id"]
        if sp["parent"] is not None:
            args["parent_id"] = sp["parent"]
        events.append(_event(sp["name"], sp["t0"], sp["t1"], pid, tid, args))
    for raw, tid in tids.items():
        events.append(_meta(pid, f"thread {raw}", tid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def cluster_timeline(schedules, *, max_chains: Optional[int] = 8,
                     time_scale: float = 1.0) -> dict:
    """Per-worker commit spans of a :class:`ClusterEngine` schedule.

    ``schedules`` is one ``WorkerSchedule`` or a per-chain sequence (as
    passed to :meth:`ClusterEngine.run`); chains beyond ``max_chains`` are
    dropped (``None`` keeps all) so a 64-chain benchmark exports a readable
    file.  Commit ``k`` by worker ``w`` renders as a span on chain-process
    ``c``'s worker-``w`` row ending at ``commit_times[k]`` and starting at
    ``w``'s previous commit (or 0) — the worker's compute+commit interval —
    with ``staleness``/``read_version``/``batch_size`` in ``args``.
    ``time_scale`` multiplies simulated time units into seconds.
    """
    if hasattr(schedules, "read_versions"):
        schedules = [schedules]
    schedules = list(schedules)
    if max_chains is not None:
        schedules = schedules[:max_chains]
    events = []
    for c, sched in enumerate(schedules):
        events.append(_meta(c, f"chain {c}"))
        delays = sched.delays
        sizes = sched.batch_sizes
        last_by_worker: dict = {}
        for k in range(len(sched)):
            w = int(sched.worker_ids[k])
            t1 = float(sched.commit_times[k]) * time_scale
            t0 = last_by_worker.get(w, 0.0)
            last_by_worker[w] = t1
            args = {"commit": k, "worker": w,
                    "staleness": int(delays[k]),
                    "read_version": int(sched.read_versions[k])}
            if sizes is not None:
                args["batch_size"] = int(sizes[k])
            alive = getattr(sched, "alive", None)
            lost = alive is not None and not bool(alive[k])
            if lost:
                args["lost"] = True  # crashed mid-commit: masked no-op
            events.append(_event("commit (lost)" if lost else "commit",
                                 t0, t1, c, w, args, cat="cluster"))
        for w in sorted(last_by_worker):
            events.append(_meta(c, f"worker {w}", w))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def decode_timeline(spans, *, pid: int = 0) -> dict:
    """``decode.generate`` spans → per-rung rows with amortized
    prefill/per-token slices (see module docstring for why token boundaries
    are amortized rather than measured)."""
    events = [_meta(pid, "decode")]
    rung_tid: dict = {}
    for sp in iter_spans(spans):
        if sp["name"] != "decode.generate":
            continue
        attrs = sp["attrs"]
        rung = (attrs.get("b_rung", 0), attrs.get("t_rung", 0))
        tid = rung_tid.setdefault(rung, len(rung_tid))
        args = dict(attrs)
        args["span_id"] = sp["id"]
        events.append(_event("decode.generate", sp["t0"], sp["t1"], pid,
                             tid, args, cat="decode"))
        new_tokens = int(attrs.get("new_tokens", 0))
        if new_tokens < 1:
            continue
        t_rung = max(int(attrs.get("t_rung", 1)), 1)
        total = sp["t1"] - sp["t0"]
        # position-proportional amortization: prefill processes t_rung
        # cached positions in one pass, each decode step one position
        unit = total / (t_rung + new_tokens)
        t = sp["t0"]
        slices = [("decode.prefill", t_rung * unit, {"positions": t_rung})]
        slices += [("decode.token", unit, {"i": i})
                   for i in range(new_tokens)]
        for name, dur, extra in slices:
            events.append(_event(name, t, t + dur, pid, tid,
                                 {**extra, "amortized": True,
                                  "b_rung": attrs.get("b_rung"),
                                  "t_rung": attrs.get("t_rung"),
                                  "request_span": sp["id"]},
                                 cat="decode"))
            t += dur
    for (b, t_), tid in rung_tid.items():
        events.append(_meta(pid, f"rung B{b}xT{t_}", tid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def paged_timeline(spans, *, pid: int = 0) -> dict:
    """``paged.*`` spans → a per-slot continuous-batching timeline.

    One thread row per serving slot, plus a ``scheduler`` row.  Per
    request: a ``paged.wait`` slice (submission → first prefill start, on
    the slot that first admitted it), each ``paged.admit`` prefill, and the
    full ``paged.request`` residency (submission → finish) with
    ``new_tokens`` / ``evictions`` in ``args``.  ``paged.decode_chunk``
    spans land on the scheduler row, showing how many slots each fused
    step chunk advanced.
    """
    events = [_meta(pid, "paged")]
    slots: set = set()
    admits: dict = defaultdict(list)  # request_id -> [admit span dicts]
    chunks, requests = [], []
    for sp in iter_spans(spans):
        if sp["name"] == "paged.admit":
            admits[sp["attrs"].get("request_id")].append(sp)
        elif sp["name"] == "paged.request":
            requests.append(sp)
        elif sp["name"] == "paged.decode_chunk":
            chunks.append(sp)
    for rid, sps in admits.items():
        sps.sort(key=lambda sp: sp["t0"])
        for sp in sps:
            s = int(sp["attrs"]["slot"])
            slots.add(s)
            events.append(_event("paged.admit", sp["t0"], sp["t1"], pid, s,
                                 dict(sp["attrs"]), cat="paged"))
    for sp in requests:
        attrs = dict(sp["attrs"])
        s = int(attrs["slot"])
        slots.add(s)
        first = admits.get(attrs.get("request_id"))
        if first:  # queue wait: submission until the first prefill starts
            events.append(_event(
                "paged.wait", sp["t0"], first[0]["t0"], pid,
                int(first[0]["attrs"]["slot"]),
                {"request_id": attrs.get("request_id")}, cat="paged"))
        events.append(_event("paged.request", sp["t0"], sp["t1"], pid, s,
                             attrs, cat="paged"))
    sched = (max(slots) + 1) if slots else 0
    for sp in chunks:
        events.append(_event("paged.decode_chunk", sp["t0"], sp["t1"], pid,
                             sched, dict(sp["attrs"]), cat="paged"))
    for s in sorted(slots):
        events.append(_meta(pid, f"slot {s}", s))
    if chunks:
        events.append(_meta(pid, "scheduler", sched))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, trace_or_spans) -> dict:
    """Write a timeline JSON; bare span lists go through
    :func:`to_chrome_trace` first.  Returns the written object."""
    trace = trace_or_spans
    if not isinstance(trace, dict):
        trace = to_chrome_trace(trace)
    if "traceEvents" not in trace:
        raise ValueError("not a Chrome trace object (missing traceEvents)")
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return trace


def validate_chrome_trace(trace: dict) -> list:
    """Schema problems (empty list = valid Chrome-trace-event JSON): the
    checks ``tests/test_torch_obs.py`` pins the timelines with."""
    problems = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "M", "i", "B", "E"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev:
            problems.append(f"event {i}: missing name/pid")
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"event {i}: bad ts {ts!r}")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
            if "tid" not in ev:
                problems.append(f"event {i}: X event without tid")
    return problems


def _iter_complete(trace: dict, name: Optional[str] = None,
                   cat: Optional[str] = None):
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        if name is not None and ev.get("name") != name:
            continue
        if cat is not None and ev.get("cat") != cat:
            continue
        yield ev


def summarize(trace: dict) -> dict:
    """Aggregate a timeline for ``scripts/torch_obstool.py``: per-(pid,
    tid) busy time and makespan (the critical path is the busiest row of the longest
    process), staleness histogram over commit spans, and tokens/sec by
    decode rung."""
    busy: dict = defaultdict(float)
    end: dict = defaultdict(float)
    names: dict = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") == "M":
            key = (ev["pid"], ev.get("tid"))
            names[key] = ev.get("args", {}).get("name", "")
    staleness: dict = defaultdict(int)
    rung: dict = defaultdict(lambda: [0, 0.0])  # tid -> [tokens, secs]
    for ev in _iter_complete(trace):
        key = (ev["pid"], ev["tid"])
        busy[key] += ev["dur"] / _US
        end[key] = max(end[key], (ev["ts"] + ev["dur"]) / _US)
        args = ev.get("args", {})
        if "staleness" in args:
            staleness[int(args["staleness"])] += 1
        if ev["name"] == "decode.token":
            r = rung[key]
            r[0] += 1
            r[1] += ev["dur"] / _US
    makespan = max(end.values(), default=0.0)
    rows = [{"pid": pid, "tid": tid,
             "label": (f"{names.get((pid, None), pid)}/"
                       f"{names.get((pid, tid), tid)}"),
             "busy_s": round(b, 6), "end_s": round(end[(pid, tid)], 6),
             "utilization": round(b / makespan, 4) if makespan else 0.0}
            for (pid, tid), b in sorted(busy.items(),
                                        key=lambda kv: -kv[1])]
    tokens_by_rung = {
        f"{names.get((pid, tid), tid)}": {
            "tokens": n, "tokens_per_s": round(n / secs, 2) if secs else None}
        for (pid, tid), (n, secs) in rung.items()}
    return {"makespan_s": round(makespan, 6), "rows": rows,
            "critical": rows[0] if rows else None,
            "staleness_hist": dict(sorted(staleness.items())),
            "tokens_by_rung": tokens_by_rung}


def _spans_or_trace(payload) -> dict:
    """``torch_obstool`` input adapter: a Chrome trace object passes through, a
    bare span-dump list converts."""
    if isinstance(payload, dict) and "traceEvents" in payload:
        return payload
    return to_chrome_trace(payload)
