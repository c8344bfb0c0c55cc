"""Gemma-3-4B [hf:google/gemma-3 family].

5:1 local:global attention (window 1024), head_dim 256, QK-norm, GeGLU,
sqrt(d) embedding scaling, 262k vocab.  34 layers = 5 full periods of 6
plus a 4-local remainder.  Sliding-window layers make long-context decode
sub-quadratic in cache size (long_500k eligible).
"""

from .base import ModelConfig

_PERIOD = (("local", "mlp"),) * 5 + (("attn", "mlp"),)

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    period=_PERIOD,
    window=1024,
    qk_norm=True,
    ffn_act="geglu",
    scale_embed=True,
    tie_embeddings=True,
    rope_theta=1e6,
    sub_quadratic=True,
    source="hf:google/gemma-3-1b-pt (scaled)",
)
