from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    MoEConfig,
    SSMConfig,
    all_configs,
    get_config,
    reduced,
)

__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "ArchConfig",
    "InputShape",
    "MoEConfig",
    "SSMConfig",
    "all_configs",
    "get_config",
    "reduced",
]
