"""repro_torch.obs — the span tracer and metrics registry the engines report
through (copies of :mod:`repro.obs.trace` and :mod:`repro.obs.metrics`;
the timeline exporter comes with a later slice)."""

from repro_torch.obs import metrics, trace  # noqa: F401
from repro_torch.obs.metrics import Registry, registry  # noqa: F401
from repro_torch.obs.trace import Span, Tracer, span, tracer  # noqa: F401
