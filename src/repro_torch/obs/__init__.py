"""repro_torch.obs — the span tracer, the metrics registry and the
Chrome-trace timeline exporter the engines report through (copies of
:mod:`repro.obs.trace`, :mod:`repro.obs.metrics` and
:mod:`repro.obs.timeline`; ``scripts/torch_obstool.py`` summarizes the
timelines).  The instrumentation bus (:mod:`repro_torch.analysis.
instrument`) feeds the registry: kernel build wall time lands there."""

from repro_torch.obs import metrics, timeline, trace  # noqa: F401
from repro_torch.obs.metrics import Registry, registry  # noqa: F401
from repro_torch.obs.timeline import (  # noqa: F401
    cluster_timeline,
    decode_timeline,
    paged_timeline,
    to_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.trace import Span, Tracer, span, trace_hook, tracer  # noqa: F401
