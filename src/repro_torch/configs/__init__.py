"""The port's model configs: the schema and every config (dense, MoE,
xLSTM, encoder-decoder, vision-language and the Mamba hybrid), copied
from ``repro.configs`` (no JAX import)."""

from .base import (
    ARCH_IDS,
    PORTED,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    get_config,
)

__all__ = ["ARCH_IDS", "PORTED", "MambaConfig", "ModelConfig", "MoEConfig",
           "get_config"]
