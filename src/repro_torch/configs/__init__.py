from repro_torch.configs.base import (
    ARCH_IDS,
    ModelConfig,
    get_config,
    normalize_arch,
)

__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "normalize_arch"]
