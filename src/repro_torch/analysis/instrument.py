"""Unified runtime instrumentation for the port's hot paths (port of
``repro.analysis.instrument``).

Every engine promises the same invariants on its hot path: **one first
sight per shape rung** (a mixed request / commit stream over warm rungs
meets no new shape) and **zero per-request host pad allocations** (padding
writes into a per-rung scratch).  There is one event bus for them:

- engines own a :class:`Counters` handle (``counters("ServeEngine")``) and
  report every shape rung they see for the first time
  (:meth:`Counters.trace`, labelled per program: the JAX package's engines
  trace a jitted function there; the port runs eagerly, so the rung's
  first sight is the event) and every host pad-scratch creation
  (:meth:`Counters.pad_alloc`) through it — the engines' public
  ``num_traces`` / ``num_host_pad_allocs`` are thin views over the handle;
- callers wrap a region in :func:`instrument` and get a :class:`Report` of
  everything that happened inside it: per-(engine, program) trace counts,
  pad allocations, the CUDA kernel builds (``nvcc`` in
  :mod:`repro_torch.kernels.build`) and their wall time, and captured
  warnings.  A measured stream whose rungs are warm must produce an *empty*
  report — :meth:`Report.stream_flags` is that assertion packaged for a
  benchmark's JSON rows, with the reference's two field names
  (``retraced_in_stream``, ``pad_allocs_in_stream``).

Compile time: the port compiles nothing per shape; its kernels are built
with ``nvcc`` at first use, one library a source.  Each build reports its
wall seconds here, per library: into every active report
(:attr:`Report.compile_ms`, keyed by the library's name) and, process-wide,
into the :mod:`repro_torch.obs.metrics` registry (a
``kernel.build_ms_total`` counter and a cumulative
``kernel.build_ms/<library>`` gauge).  :meth:`Report.to_dict` therefore
renames the reference's ``xla_compiles`` key to ``kernel_builds`` (the
number of libraries built inside the region), and adds ``sync_warnings``;
its other keys are the reference's.

``transfer_guard``: the counterpart of ``jax.transfer_guard`` is
``torch.cuda.set_sync_debug_mode`` — ``"error"`` turns an operation that
synchronises the host with the card (a device-to-host read, a blocking
copy, ``.item()``) into an error, ``"warn"`` only warns (where the
reference takes jax's ``"disallow"`` and ``"log"``).  The mode is set on
entry and the previous one restored on exit, nested regions included.  Without a card it does nothing: there is nothing to
synchronise with.

The context manager nests (inner regions report a subset of outer ones)
and costs two dict updates per event, so it is safe to leave on in
serving loops.
"""

from __future__ import annotations

import threading
import warnings
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["Counters", "Report", "counters", "instrument", "record_build"]

_lock = threading.Lock()
_active: list["Report"] = []  # instrument() stack, innermost last
_build_ms_by_lib: Counter = Counter()  # process-lifetime per-library build ms

#: the transfer_guard values: torch.cuda.set_sync_debug_mode's modes
_GUARD_MODES = ("warn", "error")


class Counters:
    """Per-engine instrument handle: monotone trace / pad-alloc counters.

    ``trace(fn)`` is called once per shape rung an engine meets for the
    first time (``fn`` names the program, e.g. ``"decode"``),
    ``pad_alloc()`` from the host padding path whenever a new scratch
    buffer is created.  Both also broadcast into every active
    :func:`instrument` region.
    """

    __slots__ = ("label", "traces", "pad_allocs", "per_fn")

    def __init__(self, label: str):
        self.label = label
        self.traces = 0
        self.pad_allocs = 0
        self.per_fn: Counter = Counter()  # program name -> traces

    def trace(self, fn: str = "") -> None:
        """Record the first sight of one shape rung of program ``fn``."""
        with _lock:
            self.traces += 1
            self.per_fn[fn] += 1
            for rep in _active:
                rep._traces[(self.label, fn)] += 1

    def pad_alloc(self) -> None:
        """Record one host pad-scratch buffer creation."""
        with _lock:
            self.pad_allocs += 1
            for rep in _active:
                rep._pad_allocs[self.label] += 1


def counters(label: str) -> Counters:
    """A fresh per-engine instrument handle."""
    return Counters(label)


def record_build(library: str, seconds: float) -> None:
    """Report one kernel library's build (``nvcc``) wall time: into every
    active report and the metrics registry."""
    from repro_torch.obs.metrics import registry

    with _lock:
        _build_ms_by_lib[library] += seconds * 1e3
        total_ms = _build_ms_by_lib[library]
        for rep in _active:
            rep._compile_secs[library] += seconds
            rep.kernel_builds += 1
    reg = registry()
    reg.counter("kernel.build_ms_total",
                "cumulative CUDA kernel build (nvcc) wall time").inc(seconds * 1e3)
    reg.gauge(f"kernel.build_ms/{library}",
              "cumulative build wall time of one kernel library").set(total_ms)


@dataclass(eq=False)  # regions are told apart by identity, never by value
class Report:
    """Everything the instrument bus saw inside one :func:`instrument`
    region.  ``num_traces``/``num_pad_allocs`` are the totals; the dict
    views break them down per (engine label, program)."""

    _traces: Counter = field(default_factory=Counter)
    _pad_allocs: Counter = field(default_factory=Counter)
    #: per-library kernel build wall time (seconds) inside the region
    _compile_secs: Counter = field(default_factory=Counter)
    #: kernel libraries built (``nvcc``) inside the region
    kernel_builds: int = 0
    #: warnings about donated buffers captured inside the region (the
    #: reference's category; the port donates nothing, so a warning here
    #: comes from code outside the port)
    donation_warnings: list = field(default_factory=list)
    #: synchronising-operation warnings of ``transfer_guard="warn"``
    sync_warnings: list = field(default_factory=list)

    @property
    def num_traces(self) -> int:
        return sum(self._traces.values())

    @property
    def num_pad_allocs(self) -> int:
        return sum(self._pad_allocs.values())

    @property
    def traces(self) -> dict:
        """{(engine label, program): trace count} inside the region."""
        return dict(self._traces)

    @property
    def pad_allocs(self) -> dict:
        """{engine label: pad-scratch creations} inside the region."""
        return dict(self._pad_allocs)

    def traces_for(self, label: str) -> int:
        return sum(n for (lbl, _), n in self._traces.items() if lbl == label)

    @property
    def compile_ms(self) -> dict:
        """{kernel library: build wall-time ms} inside the region."""
        return {k: v * 1e3 for k, v in sorted(self._compile_secs.items())}

    @property
    def compile_time_ms(self) -> float:
        """Total kernel build wall time (ms) inside the region."""
        return sum(self._compile_secs.values()) * 1e3

    def stream_flags(self) -> dict:
        """The hot-stream invariant, packaged for a benchmark JSON row: a
        measured stream over warm rungs must meet no new shape and allocate
        no pad scratch (the reference's field names)."""
        return {
            "retraced_in_stream": self.num_traces > 0,
            "pad_allocs_in_stream": self.num_pad_allocs,
        }

    def to_dict(self) -> dict:
        """JSON-serializable summary (keys flattened to 'label/fn';
        ``kernel_builds`` in place of the reference's ``xla_compiles``)."""
        return {
            "traces": {f"{lbl}/{fn}" if fn else lbl: n
                       for (lbl, fn), n in sorted(self._traces.items())},
            "pad_allocs": {lbl: n
                           for lbl, n in sorted(self._pad_allocs.items())},
            "kernel_builds": self.kernel_builds,
            "compile_ms": {k: round(v, 3)
                           for k, v in self.compile_ms.items()},
            "donation_warnings": len(self.donation_warnings),
            "sync_warnings": len(self.sync_warnings),
        }


@contextmanager
def _sync_debug(mode: Optional[str]):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the body, the previous
    mode restored after it; nothing without a card."""
    import torch

    if mode is None or not torch.cuda.is_available():
        yield
        return
    def set_mode(m):
        with warnings.catch_warnings():  # torch's notice that the mode is a prototype
            warnings.filterwarnings("ignore", message="Synchronization debug mode")
            torch.cuda.set_sync_debug_mode(m)

    prev = torch.cuda.get_sync_debug_mode()
    set_mode(mode)
    try:
        yield
    finally:
        set_mode(prev)


def _is_sync_warning(msg: str) -> bool:
    return "synchroniz" in msg.lower()


@contextmanager
def instrument(*, transfer_guard: Optional[str] = None,
               capture_donation_warnings: bool = True):
    """Collect every engine trace / pad-alloc / kernel-build event in the
    ``with`` body into a :class:`Report`.

    ``transfer_guard`` (``"error"`` / ``"warn"``) sets
    ``torch.cuda.set_sync_debug_mode`` for the region: ``"error"`` turns a hidden host sync inside the measured
    stream into a ``RuntimeError``, ``"warn"`` records each one in
    :attr:`Report.sync_warnings`.  ``capture_donation_warnings`` records
    donation-related warnings into the report instead of letting them
    scroll past; every other warning is re-emitted on exit.

        with instrument() as rep:
            for q in stream:
                engine(q)
        assert rep.num_traces == 0          # warm stream meets no new rung
        row.update(rep.stream_flags())      # -> benchmark JSON
    """
    if transfer_guard is not None and transfer_guard not in _GUARD_MODES:
        raise ValueError(f"transfer_guard must be one of {_GUARD_MODES}, "
                         f"got {transfer_guard!r}")
    mode = transfer_guard
    report = Report()
    catcher = None
    caught: list = []
    if capture_donation_warnings or mode == "warn":
        catcher = warnings.catch_warnings(record=True)
        caught = catcher.__enter__()
        warnings.simplefilter("always")
    with _lock:
        _active.append(report)
    try:
        with _sync_debug(mode):
            yield report
    finally:
        with _lock:
            _active.remove(report)
        if catcher is not None:
            catcher.__exit__(None, None, None)
            for w in caught:
                msg = str(w.message)
                if capture_donation_warnings and "donat" in msg.lower():
                    report.donation_warnings.append(msg)
                elif mode == "warn" and _is_sync_warning(msg):
                    report.sync_warnings.append(msg)
                else:  # not ours: hand it back to the outer filters
                    warnings.warn_explicit(w.message, w.category,
                                           w.filename, w.lineno)
