from repro_torch.configs.base import (
    ARCH_IDS,
    BlockDef,
    ModelConfig,
    get_config,
    list_configs,
    register,
)

__all__ = ["ARCH_IDS", "BlockDef", "ModelConfig", "get_config", "list_configs", "register"]
