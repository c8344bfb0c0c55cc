"""Jamba-1.5-Large (398B total / 94B active) [arXiv:2403.19887; hf].

Hybrid Mamba+attention at 1:7 attn:mamba, MoE (16 experts, top-2) on every
second layer.  8-layer period: attention at position 4, MoE on odd
positions; 72 layers = 9 periods.  Verified param count ~398B (DESIGN.md).
"""

from .base import MambaConfig, ModelConfig, MoEConfig

_PERIOD = (
    ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
    ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    period=_PERIOD,
    moe=MoEConfig(n_experts=16, top_k=2, pad_to=16),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False,
    ffn_act="swiglu",
    rope_theta=1e6,
    sub_quadratic=True,
    opt_state_dtype="bfloat16",  # fits 16GB HBM at 256 chips (DESIGN §8)
    source="arXiv:2403.19887",
)
