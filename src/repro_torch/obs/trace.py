"""Low-overhead host-side span tracer for the serving hot paths (a copy of
``repro.obs.trace``).

A span is one wall-clock interval with a name, attributes, and a parent —
``with span("decode.generate", b_rung=8): ...`` records where the time went.
Spans open and close on the host around device work; a span that must see
the device's time ends after a host read of the result, which waits for
the card.

Cost discipline: the global tracer starts **disabled**, and a disabled
``span()`` returns a shared no-op context — two attribute loads and a
branch, no allocation — so engines leave their span sites on permanently.
Enabled spans cost one clock read on entry and one on exit plus a list
append; parents are linked through a per-thread stack, so concurrent
serving threads get independent span trees over one shared buffer.

Timestamps are seconds on a process-local monotonic clock
(``perf_counter`` minus the module-import epoch); the Chrome-trace exporter
(:mod:`repro_torch.obs.timeline`) converts them to the microsecond ``ts``
Perfetto expects.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Iterator, Optional

__all__ = ["Span", "Tracer", "disable", "enable", "iter_spans", "now", "span",
           "trace_hook", "tracer"]

_EPOCH = time.perf_counter()


def now() -> float:
    """Seconds since the tracer epoch (process-local monotonic clock)."""
    return time.perf_counter() - _EPOCH


class Span:
    """One recorded interval: ``[t0, t1]`` seconds since the tracer epoch,
    parent-linked into this thread's span tree."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "attrs", "tid")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 t0: float, attrs: dict, tid: int):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = t0
        self.attrs = attrs
        self.tid = tid

    def set(self, **attrs) -> "Span":
        """Attach attributes after entry (e.g. results known only on exit)."""
        self.attrs.update(attrs)
        return self

    @property
    def duration(self) -> float:
        """Wall seconds from entry to exit (0 while still open)."""
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        """JSON-ready form: name, ids, timestamps, thread, attrs."""
        return {"name": self.name, "id": self.span_id,
                "parent": self.parent_id, "t0": self.t0, "t1": self.t1,
                "tid": self.tid, "attrs": dict(self.attrs)}


class _NullSpan:
    """The shared span handed out while tracing is disabled."""

    __slots__ = ()

    def set(self, **_attrs) -> "_NullSpan":
        return self


class _NullCtx:
    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL_SPAN

    def __exit__(self, *_exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()
_NULL_CTX = _NullCtx()


class _SpanCtx:
    """Context manager for one live span (hand-rolled: no generator frame
    per call on the hot path)."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        stack = self._tracer._stack()
        if stack:
            self._span.parent_id = stack[-1].span_id
        stack.append(self._span)
        self._span.t0 = now()
        return self._span

    def __exit__(self, *_exc) -> bool:
        sp = self._span
        sp.t1 = now()
        self._tracer._stack().pop()
        with self._tracer._lock:
            self._tracer._spans.append(sp)
        return False


class Tracer:
    """A span buffer plus per-thread parent stacks.

    One process-global instance (:func:`tracer`) serves the engines; tests
    construct private ones.  ``record()`` backfills a span from timestamps
    measured elsewhere (an engine hook timing the chunk that just ran) —
    it participates in parent linking but not in the live stack.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def enable(self) -> "Tracer":
        """Start recording spans; returns self for chaining."""
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        """Stop recording (``span()`` hands out no-op spans); returns self."""
        self.enabled = False
        return self

    def span(self, name: str, **attrs):
        """Context manager recording one span around its body."""
        if not self.enabled:
            return _NULL_CTX
        sp = Span(name, next(self._ids), None, 0.0, attrs,
                  threading.get_ident())
        return _SpanCtx(self, sp)

    def record(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Backfill a completed span from caller-measured timestamps
        (seconds on the :func:`now` clock).  No-op while disabled."""
        if not self.enabled:
            return
        sp = Span(name, next(self._ids), None, t0, attrs,
                  threading.get_ident())
        sp.t1 = t1
        stack = self._stack()
        if stack:
            sp.parent_id = stack[-1].span_id
        with self._lock:
            self._spans.append(sp)

    @property
    def spans(self) -> list:
        """Snapshot copy of every recorded span, in completion order."""
        with self._lock:
            return list(self._spans)

    def drain(self) -> list:
        """All recorded spans, clearing the buffer."""
        with self._lock:
            out, self._spans = self._spans, []
        return out

    def clear(self) -> None:
        """Drop every recorded span without returning them."""
        with self._lock:
            self._spans.clear()

    def to_dicts(self) -> list:
        """:meth:`Span.to_dict` over :attr:`spans` (JSON-ready list)."""
        return [sp.to_dict() for sp in self.spans]


_GLOBAL = Tracer()


def tracer() -> Tracer:
    """The process-global tracer every engine reports through."""
    return _GLOBAL


def span(name: str, **attrs):
    """``with span("serve.request", rung=8) as sp:`` on the global tracer."""
    if not _GLOBAL.enabled:
        return _NULL_CTX
    return _GLOBAL.span(name, **attrs)


def enable() -> Tracer:
    """Turn on the process-global tracer; returns it."""
    return _GLOBAL.enable()


def disable() -> Tracer:
    """Turn off the process-global tracer; returns it."""
    return _GLOBAL.disable()


def trace_hook(name: str = "engine.chunk",
               to: Optional[Tracer] = None) -> Callable:
    """An :class:`~repro_torch.train.engine.Engine` or
    :class:`~repro_torch.cluster.executor.ClusterEngine` hook emitting one
    span per chunk boundary.

    Hooks run between chunks, so each span covers the host interval
    from the previous boundary (or hook creation) to this one — dispatch,
    device wait, and sibling hooks included.  Attributes carry the commit
    range.  This is the sanctioned way to see chunk timing without touching
    the commit loop.
    """
    target = to if to is not None else _GLOBAL
    prev = [now(), 0]  # [boundary time, step at that boundary]

    def hook(step_end: int, _state, _aux) -> None:
        t = now()
        target.record(name, prev[0], t, start=prev[1], end=step_end)
        prev[0], prev[1] = t, step_end

    return hook


def iter_spans(spans) -> Iterator[dict]:
    """Normalize ``Span`` objects / dicts into dicts (shared by the timeline
    exporter and ``scripts/torch_obstool.py``)."""
    for sp in spans:
        yield sp.to_dict() if isinstance(sp, Span) else sp
