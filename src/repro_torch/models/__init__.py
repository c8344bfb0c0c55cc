"""The port's LM substrate for the dense decoders: layers, attention (prefill
through the flash kernel wrapper), and the stack with its serving passes."""

from .transformer import (
    DecoderLM,
    decode_step,
    init_caches,
    init_params,
    model_spec,
    prefill,
)

__all__ = ["DecoderLM", "decode_step", "init_caches", "init_params",
           "model_spec", "prefill"]
