from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_is_applicable,
    get_config,
    normalize_arch,
)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "cell_is_applicable", "get_config", "normalize_arch"]
