"""The paper's experiments (port of ``repro.experiments``): §3.2
polynomial-regression posterior sampling and §3.3 Reconstruction ICA, each
comparing Sync, W-Con and W-Icon."""

from repro_torch.experiments.regression import run_regression_experiment  # noqa: F401
from repro_torch.experiments.rica import run_rica_experiment  # noqa: F401
