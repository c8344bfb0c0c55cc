"""OLMoE-1B-7B (6.9B total / 1.3B active) [arXiv:2409.02060; hf].

64 experts, top-8, QK-norm.
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    period=(("attn", "moe"),),
    moe=MoEConfig(n_experts=64, top_k=8, pad_to=16),
    ffn_act="swiglu",
    qk_norm=True,
    tie_embeddings=False,
    source="arXiv:2409.02060",
)
