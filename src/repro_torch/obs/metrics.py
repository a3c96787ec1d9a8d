"""Process-global metrics registry: counters, gauges, fixed-bucket histograms
(a copy of ``repro.obs.metrics``).

The quantities serving is judged by — per-token decode latency, time to
first token, slot occupancy, cache-bank utilization — are recorded here by
the engines as they run, cheaply enough to stay on in production serving loops (a counter
``inc`` is one float add under a slot attribute; a histogram ``observe`` is
one ``bisect`` plus two adds).  Buckets are **fixed at construction**, so a
histogram never reallocates on the hot path and snapshots from different
processes are mergeable bucket-by-bucket.

Two export formats:

- :meth:`Registry.snapshot` → a JSON-ready dict;
  :meth:`Registry.write_snapshot` / :meth:`Registry.append_jsonl` persist it;
- :meth:`Registry.prometheus` → Prometheus text exposition (counters,
  gauges, and cumulative ``_bucket`` histograms), so a scrape endpoint is a
  file write away.

Engines use the process-global :func:`registry`; tests construct private
:class:`Registry` instances (or read deltas of the global one — every value
is monotone or last-write).
"""

from __future__ import annotations

import bisect
import json
import math
import re
import threading
from typing import Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "registry",
           "LATENCY_MS_BUCKETS", "STALENESS_BUCKETS"]

#: default rungs for millisecond-latency histograms (log-ish ladder)
LATENCY_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0)
#: default rungs for per-commit staleness histograms (powers of two)
STALENESS_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128)


class Counter:
    """Monotone float counter."""

    __slots__ = ("name", "help", "_value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0 — counters only go up)."""
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self._value += n

    @property
    def value(self) -> float:
        """Current running total."""
        return self._value

    def to_dict(self) -> dict:
        """JSON-ready ``{"type", "value"}`` form for snapshots."""
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "help", "_value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self._value = math.nan

    def set(self, v: float) -> None:
        """Overwrite the gauge with ``v`` (last write wins)."""
        self._value = float(v)

    @property
    def value(self) -> float:
        """Last value set (NaN before the first ``set``)."""
        return self._value

    def to_dict(self) -> dict:
        """JSON-ready ``{"type", "value"}`` form for snapshots."""
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram: ``bounds`` are inclusive upper edges, with an
    implicit +inf overflow bucket; ``counts[i]`` holds observations ``<=
    bounds[i]`` and ``> bounds[i-1]``."""

    __slots__ = ("name", "help", "bounds", "counts", "total", "sum")
    kind = "histogram"

    def __init__(self, name: str, bounds: Sequence[float],
                 help: str = ""):  # noqa: A002
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name} needs ascending bucket "
                             f"bounds, got {bounds!r}")
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # + overflow
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        """Record one observation into its bucket (and total/sum)."""
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v

    def observe_many(self, values) -> None:
        """Bulk observe (host arrays from a schedule or a latency list) —
        one pass, no per-element Python dispatch for the common case."""
        for v in values:
            v = float(v)
            self.counts[bisect.bisect_left(self.bounds, v)] += 1
            self.total += 1
            self.sum += v

    @property
    def mean(self) -> float:
        """Exact mean of all observations (NaN when empty)."""
        return self.sum / self.total if self.total else math.nan

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the ``q``-quantile (a
        conservative estimate — exact values are not retained)."""
        if not self.total:
            return math.nan
        rank = q * self.total
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return (self.bounds[i] if i < len(self.bounds)
                        else math.inf)
        return math.inf

    def to_dict(self) -> dict:
        """JSON-ready bucket layout: bounds, counts, count, sum."""
        return {"type": "histogram", "bounds": list(self.bounds),
                "counts": list(self.counts), "count": self.total,
                "sum": self.sum}


_PROM_SAN = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    n = _PROM_SAN.sub("_", name)
    return n if not n[:1].isdigit() else f"_{n}"


class Registry:
    """Name → metric map with idempotent, type-checked constructors.

    ``counter``/``gauge``/``histogram`` return the existing metric when the
    name is already registered (so call sites need no module-level
    plumbing) and raise if the registered kind differs — a name means one
    thing process-wide.
    """

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, make):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = make()
            elif m.kind != kind:
                raise TypeError(f"metric {name!r} is a {m.kind}, "
                                f"not a {kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        """Get-or-create the :class:`Counter` registered under ``name``."""
        return self._get(name, "counter", lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:  # noqa: A002
        """Get-or-create the :class:`Gauge` registered under ``name``."""
        return self._get(name, "gauge", lambda: Gauge(name, help))

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None,
                  help: str = "") -> Histogram:  # noqa: A002
        """Get-or-create the :class:`Histogram` under ``name``; ``bounds``
        default to the latency-ms buckets and only apply on creation."""
        return self._get(name, "histogram",
                         lambda: Histogram(name, bounds or LATENCY_MS_BUCKETS,
                                           help))

    def get(self, name: str):
        """The metric registered under ``name``, or None."""
        return self._metrics.get(name)

    def names(self) -> list:
        """Sorted list of every registered metric name."""
        with self._lock:
            return sorted(self._metrics)

    # -- export ---------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready ``{name: metric dict}`` (NaN gauges are omitted —
        ``json`` would emit invalid ``NaN`` literals)."""
        out = {}
        with self._lock:
            for name in sorted(self._metrics):
                d = self._metrics[name].to_dict()
                if d["type"] == "gauge" and math.isnan(d["value"]):
                    continue
                out[name] = d
        return out

    def write_snapshot(self, path) -> dict:
        """Dump :meth:`snapshot` to ``path`` as pretty JSON; returns it."""
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        return snap

    def append_jsonl(self, path, **extra) -> None:
        """Append one ``{**extra, "metrics": snapshot}`` JSON line — the
        trend-trail format (nightly CI appends one line per run)."""
        with open(path, "a") as f:
            json.dump({**extra, "metrics": self.snapshot()}, f,
                      sort_keys=True)
            f.write("\n")

    def prometheus(self) -> str:
        """Prometheus text exposition of the whole registry."""
        lines = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                pname = _prom_name(name)
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} {m.kind}")
                if m.kind == "histogram":
                    acc = 0
                    for bound, c in zip(m.bounds, m.counts):
                        acc += c
                        lines.append(
                            f'{pname}_bucket{{le="{bound:g}"}} {acc}')
                    lines.append(f'{pname}_bucket{{le="+Inf"}} {m.total}')
                    lines.append(f"{pname}_sum {m.sum:g}")
                    lines.append(f"{pname}_count {m.total}")
                elif not (m.kind == "gauge" and math.isnan(m.value)):
                    lines.append(f"{pname} {m.value:g}")
        return "\n".join(lines) + "\n"


_GLOBAL = Registry()


def registry() -> Registry:
    """The process-global registry every engine publishes into."""
    return _GLOBAL
