"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

Transformer backbone only; dynamic-resolution vision frontend is a stub —
``input_specs()`` supplies precomputed patch embeddings + merge mask +
M-RoPE (temporal/height/width) position ids with sections (16, 24, 24).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    period=(("attn", "mlp"),),
    ffn_act="swiglu",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    tie_embeddings=False,
    vision_stub=True,
    opt_state_dtype="bfloat16",
    source="arXiv:2409.12191",
)
