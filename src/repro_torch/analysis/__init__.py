"""repro_torch.analysis — static analysis and runtime instrumentation
(port of ``repro.analysis``).

Two halves of one correctness story for the delayed-gradient executor and
the serving stack built on it:

- :mod:`repro_torch.analysis.lint` is an AST linter for the port's
  invariants — recompile hazards, async-copy sources written before a
  sync, RNG key reuse and global-generator draws, host syncs inside step
  bodies, in-place kernels that do not bump autograd's version counter,
  mesh axes the mesh lacks (rules TL001–TL006, the reference's JL001–JL006
  in PyTorch's idiom; ``scripts/torch_lint.py`` is the CLI, and the port's
  tree lints clean under it);
- :mod:`repro_torch.analysis.instrument` is the runtime half (port of
  ``repro.analysis.instrument``): one event bus for shape-rung first
  sights, host pad-scratch allocations, CUDA kernel builds and captured
  warnings, consumed by the engines, ``chip_smoke.py`` and the tests.
"""

from repro_torch.analysis.instrument import (  # noqa: F401
    Counters,
    Report,
    counters,
    instrument,
    record_build,
)
from repro_torch.analysis.lint import (  # noqa: F401
    Finding,
    RULES,
    lint_file,
    lint_paths,
    lint_source,
)
