"""Convergence metrics of the paper's experiments (port of
``repro.metrics``): Wasserstein-2 and KL estimators, in float32."""

from repro_torch.metrics.kl import gaussian_kl, kl_samples_to_gaussian, knn_kl_estimate  # noqa: F401
from repro_torch.metrics.wasserstein import (  # noqa: F401
    gaussian_w2,
    sinkhorn_w2,
    w2_empirical_1d,
    w2_to_gaussian,
)
