"""Model configurations: a copy of ``repro/configs`` (pure Python data)."""
from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    pad_vocab,
)

__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "get_config",
    "pad_vocab",
]
