"""repro_torch.analysis — runtime instrumentation (port of
``repro.analysis.instrument``): one event bus for shape-rung first sights,
host pad-scratch allocations, CUDA kernel builds and captured warnings,
consumed by the engines, ``chip_smoke.py`` and the tests.  The reference's
static half, the JAX/Pallas AST linter ``repro.analysis.lint``, is not
ported: its rules are about JAX tracing."""

from repro_torch.analysis.instrument import (  # noqa: F401
    Counters,
    Report,
    counters,
    instrument,
    record_build,
)
