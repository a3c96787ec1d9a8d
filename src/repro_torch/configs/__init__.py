from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    ShapeConfig,
    get_arch,
    get_reduced,
)
