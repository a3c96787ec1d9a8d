"""The SGLD configuration record (port of ``repro.core.sgld``'s
``SGLDConfig``; the deprecated ``SGLDSampler`` shim is not ported — build
samplers with :func:`repro_torch.samplers.sgld`).

Update rule (paper eq. (4)):

    X_{k+1} = X_k - gamma_k * grad U(X_hat_k) + sqrt(2 sigma gamma_k) * G_k

with four read models for ``X_hat_k``: ``sync`` (X_hat = X_k),
``consistent`` (W-Con whole-vector stale read), ``inconsistent`` (W-Icon
per-coordinate read), ``pipeline`` (previous gradient).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.schedules import Schedule


@dataclass(frozen=True)
class SGLDConfig:
    mode: str = "sync"  # sync | consistent | inconsistent | pipeline
    gamma: float | Schedule = 1e-2
    sigma: float = 1.0  # temperature (paper's sigma; nu^2 of injected noise)
    tau: int = 0        # max delay == ring depth - 1 (consistent/inconsistent)
    noise_dtype: Any = torch.float32

    def __post_init__(self):
        if self.mode not in ("sync", "consistent", "inconsistent", "pipeline"):
            raise ValueError(f"unknown SGLD mode {self.mode!r}")
        if self.mode in ("consistent", "inconsistent") and self.tau < 1:
            raise ValueError(f"mode {self.mode!r} needs tau >= 1")
