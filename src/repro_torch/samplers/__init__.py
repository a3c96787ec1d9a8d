"""Composable sampler-transform API (port of ``repro.samplers``): the
``(init, update)`` primitives, a :func:`chain` combinator, the delay
policies, and the :func:`sgld` preset in the paper's four read models.
The training engine over these samplers is
:class:`repro_torch.train.engine.Engine`."""

from repro_torch.samplers.base import Sampler, SamplerState  # noqa: F401
from repro_torch.samplers.policies import (  # noqa: F401
    ConstantDelay,
    DelayPolicy,
    PerCoordinateDelay,
    TraceDelay,
)
from repro_torch.samplers.presets import MODES, from_config, sgld  # noqa: F401
from repro_torch.samplers.transform import (  # noqa: F401
    SamplerTransform,
    StepContext,
    chain,
    stateless,
)
from repro_torch.samplers.transforms import (  # noqa: F401
    apply_sgld_update,
    delay_read,
    fused_update,
    gradients,
    langevin_noise,
    noise_like,
    pipeline_overlap,
    sgld_apply,
)
