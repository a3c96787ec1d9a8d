"""Core: the paper's contribution — delayed-gradient SGLD's ring buffer,
delay model, potentials, schedules, configuration and theory (port of
``repro.core``; the deprecated ``SGLDSampler`` shim is not ported)."""

from repro_torch.core.delay import (  # noqa: F401
    RingBuffer,
    StalenessError,
    check_staleness_fits,
    init_ring,
    push,
    read_consistent,
    read_inconsistent,
    ring_depths,
    sample_coordinate_delays,
    validate_staleness,
)
from repro_torch.core.delay_model import (  # noqa: F401
    BATCH_POLICIES,
    DelayTrace,
    FaultPlan,
    WorkerModel,
    constant_delays,
    simulate_async,
    simulate_sync,
    speedup_vs_sync,
    truncate_to_evals,
)
from repro_torch.core.potentials import PolyRegression, Quadratic, RICA  # noqa: F401
from repro_torch.core.schedules import clip_to_theory, constant, poly_decay, wsd  # noqa: F401
from repro_torch.core.sgld import SGLDConfig  # noqa: F401
from repro_torch.core.theory import (  # noqa: F401
    ProblemConstants,
    gamma_eps_kl,
    gamma_eps_w2,
    gamma_terms,
    n_eps_kl,
    n_eps_w2,
)
