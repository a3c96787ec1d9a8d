"""Composable sampler-transform API for the delayed-gradient sampler zoo
(port of ``repro.samplers``): the ``(init, update)`` primitives, a
:func:`chain` combinator, the delay policies, and the :func:`sgld` /
:func:`svrg` / :func:`sghmc` presets in the paper's four read models.
The training engine over these samplers is
:class:`repro_torch.train.engine.Engine`; the multi-chain one is
:class:`repro_torch.cluster.ClusterEngine`."""

from repro_torch.samplers.base import Sampler, SamplerState  # noqa: F401
from repro_torch.samplers.policies import (  # noqa: F401
    ConstantDelay,
    DelayPolicy,
    PerCoordinateDelay,
    TraceDelay,
)
from repro_torch.samplers.presets import (  # noqa: F401
    MODES,
    from_config,
    sghmc,
    sgld,
    svrg,
)
from repro_torch.samplers.transform import (  # noqa: F401
    SamplerTransform,
    StepContext,
    chain,
    stateless,
)
from repro_torch.samplers.transforms import (  # noqa: F401
    MaskedBatch,
    SVRGState,
    apply_sgld_update,
    batch_mask,
    batch_scaled_gamma,
    delay_read,
    fused_update,
    gradients,
    langevin_noise,
    masked_gradients,
    masked_mean,
    noise_like,
    pipeline_overlap,
    sghmc_update,
    sgld_apply,
    stale_correction,
    svrg_gradients,
)
