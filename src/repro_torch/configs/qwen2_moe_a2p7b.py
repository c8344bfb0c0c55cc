"""Qwen1.5-MoE-A2.7B (14.3B total / 2.7B active) [hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts (top-4, d_ff 1408) + 4 shared experts (combined 5632).
60 experts are padded to 64 for clean EP=16 sharding; router masks padding
(DESIGN.md §8.3).
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    period=(("attn", "moe"),),
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, pad_to=16),
    ffn_act="swiglu",
    rope_theta=1e6,
    tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
