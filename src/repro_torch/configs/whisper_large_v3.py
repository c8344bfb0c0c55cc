"""Whisper-large-v3 (1.55B) [arXiv:2212.04356].

Encoder-decoder; the conv frontend is a stub — ``input_specs()`` supplies
post-conv frame embeddings (B, frames, d_model).  Sinusoidal positions,
GELU MLP.  ``n_layers`` is the decoder depth; encoder depth matches.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    kind="encdec",
    n_layers=32,
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    period=(("attn", "mlp"),),
    ffn_act="gelu",
    pos_embed="sinusoidal",
    tie_embeddings=True,
    audio_stub=True,
    source="arXiv:2212.04356",
)
