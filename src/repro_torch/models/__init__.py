"""The port's LM substrate: layers, attention (prefill, the encoder and
cross-attention through the flash kernel wrapper), MoE, xLSTM, and the
decoder and encoder-decoder stack with its training and serving
passes."""

from .transformer import (
    DecoderLM,
    decode_step,
    forward_train,
    init_caches,
    init_params,
    lm_loss,
    make_trainable,
    model_spec,
    prefill,
)

__all__ = ["DecoderLM", "decode_step", "forward_train", "init_caches",
           "init_params", "lm_loss", "make_trainable", "model_spec",
           "prefill"]
