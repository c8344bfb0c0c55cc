"""Minitron-8B (pruned Nemotron-4) [arXiv:2407.14679; hf].

Squared-ReLU MLP (2-matrix), GQA kv=8, untied 256k embeddings.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    period=(("attn", "mlp"),),
    ffn_act="relu2",
    rope_theta=1e4,
    tie_embeddings=False,
    source="arXiv:2407.14679",
)
