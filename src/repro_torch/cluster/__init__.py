"""The port's cluster: the multi-chain async-SGLD executor
(:mod:`~repro_torch.cluster.schedule`, :mod:`~repro_torch.cluster.ensemble`,
:class:`ClusterEngine`) and the serving engines (the request API, the
posterior-predictive :class:`ServeEngine`, the streaming
:class:`DecodeEngine` and the continuously-batched
:class:`PagedDecodeEngine`)."""

from repro_torch.cluster.api import (  # noqa: F401
    Completion,
    QueueFullError,
    Request,
)
from repro_torch.cluster.decode import DecodeEngine, DecodeResult  # noqa: F401
from repro_torch.cluster.ensemble import (  # noqa: F401
    chain_positions,
    diagnostics_recorder,
    ensemble_step,
    ensemble_w2,
    ess,
    healthy_chains,
    init_ensemble,
    split_rhat,
    step_chains,
    w2_recorder,
    worker_keys,
)
from repro_torch.cluster.executor import ClusterEngine  # noqa: F401
from repro_torch.cluster.paged import PageAllocator, PagedDecodeEngine  # noqa: F401
from repro_torch.cluster.schedule import (  # noqa: F401
    StalenessError,
    WorkerSchedule,
    ensemble_async,
    stack_batch_info,
    stack_liveness,
    stack_schedules,
    stack_worker_info,
)
from repro_torch.cluster.serve import (  # noqa: F401
    ServeEngine,
    ServeResult,
    bucket_size,
    predictive_stats,
)
