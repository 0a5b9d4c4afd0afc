from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ArchConfig,
    ShapeCfg,
    get_config,
    reduced,
)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeCfg", "get_config", "reduced"]
