"""The port's model configs: the schema and the four dense decoder configs,
copied from ``repro.configs`` (no JAX import)."""

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
