"""Gemma-2-2B [arXiv:2408.00118].

Alternating local(4096):global attention, attention- and logit-softcap,
head_dim 256, GeGLU, sqrt(d) embedding scaling.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    period=(("local", "mlp"), ("attn", "mlp")),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    ffn_act="geglu",
    scale_embed=True,
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2408.00118",
)
