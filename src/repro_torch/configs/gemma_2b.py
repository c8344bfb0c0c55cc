"""Gemma-2B [arXiv:2403.08295].

MQA (single KV head), head_dim 256, GeGLU, d_ff 16384 (wide), sqrt(d)
embedding scaling, tied 256k embeddings.  Pure full attention.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    period=(("attn", "mlp"),),
    ffn_act="geglu",
    scale_embed=True,
    tie_embeddings=True,
    source="arXiv:2403.08295",
)
