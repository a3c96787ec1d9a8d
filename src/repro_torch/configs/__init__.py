from repro_torch.configs.base import (  # noqa: F401
    ALIASES,
    ARCH_IDS,
    SHAPES,
    ArchConfig,
    ShapeConfig,
    all_archs,
    get_arch,
    get_reduced,
    get_shape,
)
