"""The port's model configs: the schema and the ported configs (dense, MoE,
xLSTM, encoder-decoder and vision-language), copied from ``repro.configs``
(no JAX import)."""

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
