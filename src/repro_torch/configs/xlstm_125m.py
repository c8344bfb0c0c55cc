"""xLSTM-125M [arXiv:2405.04517].

sLSTM + mLSTM blocks at 1:3 (period [m, m, m, s]); blocks carry their own
up/down projections so there is no separate FFN (d_ff = 0).  Recurrent
decode state is O(1) per token (long_500k eligible).
"""

from .base import ModelConfig

_PERIOD = (("mlstm", "none"),) * 3 + (("slstm", "none"),)

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    period=_PERIOD,
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2405.04517",
)
