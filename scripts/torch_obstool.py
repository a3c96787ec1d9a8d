#!/usr/bin/env python
"""torch_obstool CLI — summarize the port's timelines and metrics snapshots
(the twin of ``scripts/obstool.py`` over :mod:`repro_torch.obs.timeline`).

    python scripts/torch_obstool.py smoke_out/tooling/decode.timeline.json
    python scripts/torch_obstool.py paged.timeline.json --metrics metrics.json
    python scripts/torch_obstool.py --metrics metrics.json

Reads a Chrome-trace-event JSON timeline (``repro_torch.obs.timeline.
write_chrome_trace``; or a bare span dump — a JSON list of span dicts) and
prints the critical path (busiest row of the timeline), per-row busy time
and utilization, the staleness histogram over cluster commit spans, and
tokens/sec per decode rung.  ``--metrics`` pretty-prints a registry
snapshot (``registry().write_snapshot``) alongside, or alone.

Pure stdlib + :mod:`repro_torch.obs.timeline` (which imports neither
torch nor JAX), so it runs anywhere the files land.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# runnable straight from a checkout, no install step
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.obs.timeline import (  # noqa: E402
    _spans_or_trace,
    summarize,
    validate_chrome_trace,
)


def _fmt_rows(rows, limit: int) -> str:
    lines = [f"{'row':<40} {'busy s':>10} {'end s':>10} {'util':>6}"]
    for r in rows[:limit]:
        lines.append(f"{r['label']:<40} {r['busy_s']:>10.4f} "
                     f"{r['end_s']:>10.4f} {r['utilization']:>6.1%}")
    if len(rows) > limit:
        lines.append(f"... {len(rows) - limit} more rows")
    return "\n".join(lines)


def print_timeline(path: str, *, limit: int = 12, out=None) -> int:
    out = out if out is not None else sys.stdout
    with open(path) as f:
        trace = _spans_or_trace(json.load(f))
    problems = validate_chrome_trace(trace)
    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=out)
        return 1
    s = summarize(trace)
    print(f"== {path}", file=out)
    print(f"makespan: {s['makespan_s']:.4f}s over "
          f"{len(s['rows'])} timeline rows", file=out)
    if s["critical"]:
        c = s["critical"]
        print(f"critical path: {c['label']} "
              f"(busy {c['busy_s']:.4f}s, {c['utilization']:.1%} of "
              "makespan)", file=out)
    print(_fmt_rows(s["rows"], limit), file=out)
    if s["staleness_hist"]:
        total = sum(s["staleness_hist"].values())
        print("staleness over commit spans:", file=out)
        for tau, n in s["staleness_hist"].items():
            bar = "#" * max(1, round(40 * n / total))
            print(f"  tau={tau:>4} {n:>7} {bar}", file=out)
    if s["tokens_by_rung"]:
        print("decode tokens/sec by rung (amortized):", file=out)
        for label, r in sorted(s["tokens_by_rung"].items()):
            tps = r["tokens_per_s"]
            print(f"  {label:<16} {r['tokens']:>7} tokens"
                  + (f"  {tps:>10.1f} tok/s" if tps else ""), file=out)
    return 0


def _hist_quantile(bounds, counts, total, q) -> float:
    """Upper bucket bound holding the q-quantile (mirrors
    Histogram.quantile, recomputed from the snapshot)."""
    rank, acc = q * total, 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= rank:
            return bounds[i] if i < len(bounds) else float("inf")
    return float("inf")


def print_metrics(path: str, out=None) -> int:
    out = out if out is not None else sys.stdout
    with open(path) as f:
        snap = json.load(f)
    print(f"== {path}", file=out)
    for name, d in sorted(snap.items()):
        if d["type"] in ("counter", "gauge"):
            print(f"  {d['type']:<9} {name:<38} {d['value']:>14.4f}",
                  file=out)
        else:
            n = d["count"]
            mean = d["sum"] / n if n else float("nan")
            p50 = _hist_quantile(d["bounds"], d["counts"], n, 0.5)
            p99 = _hist_quantile(d["bounds"], d["counts"], n, 0.99)
            print(f"  histogram {name:<38} n={n} mean={mean:.4f} "
                  f"p50<={p50:g} p99<={p99:g}", file=out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_obstool", description=__doc__)
    ap.add_argument("timeline", nargs="?",
                    help="Chrome-trace JSON (or bare span-dump list)")
    ap.add_argument("--metrics", help="metrics snapshot JSON to pretty-print")
    ap.add_argument("--rows", type=int, default=12,
                    help="timeline rows to print (default 12)")
    args = ap.parse_args(argv)
    if not args.timeline and not args.metrics:
        ap.error("give a timeline file and/or --metrics")
    rc = 0
    if args.timeline:
        rc = print_timeline(args.timeline, limit=args.rows)
    if args.metrics:
        rc = max(rc, print_metrics(args.metrics))
    return rc


if __name__ == "__main__":
    sys.exit(main())
