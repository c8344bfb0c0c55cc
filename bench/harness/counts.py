"""The frozen operation and byte counts of the benchmark's metrics.

Model FLOPs of a prefill call count what the model needs, not what the
program's kernels happen to do: 2 x the active weights of the products
x the tokens (each MoE layer counts its router over the real experts
and ``top_k`` of them, not the capacity's padding slots), plus causal
attention 2 B S^2 H hd a layer, plus the head at the last position only
(``prefill`` computes only that position's logits).  This differs from
``repro_torch.launch.roofline.model_flops``, which leaves attention out
and counts the head over every token.

A decode step's roofline takes the larger of its FLOPs over the
bfloat16 peak and its bytes over the HBM bandwidth.  The bytes read
every non-expert weight once, every expert of each MoE layer once (at
batch 32 and top-2 of 16 the expected number of distinct experts picked
is 15.7, so this is about 2% high), the KV cache up to the step's
position and the Mamba states, and write the new token's K/V and the
states.
"""

from __future__ import annotations

from .spec import ModelSpec

__all__ = ["PEAK_BF16_FLOPS", "HBM_BYTES_S", "token_flops",
           "attention_flops", "prefill_flops", "scan_bytes",
           "decode_flops", "decode_bytes", "step_floor_s"]

#: NVIDIA H100 SXM data sheet: dense bfloat16 tensor-core rate, HBM3
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
#: bytes of a bfloat16 weight or activation, of a float32 state
BF16, F32 = 2, 4


def _mixer_weights(spec: ModelSpec, mixer: str) -> int:
    d = spec.d
    if mixer == "attn":
        return 2 * d * spec.n_heads * spec.hd + 2 * d * spec.n_kv * spec.hd
    m = spec.mamba
    di = m.d_inner
    return (d * 2 * di + m.d_conv * di + di * (m.dt_rank + 2 * m.d_state)
            + m.dt_rank * di + di * d)


def _ffn_active(spec: ModelSpec, ffn: str) -> int:
    d = spec.d
    if ffn == "mlp":
        return 3 * d * spec.d_ff
    m = spec.moe
    return (d * m.n_experts + m.top_k * 3 * d * m.d_ff
            + 3 * d * m.shared_ff)


def token_flops(spec: ModelSpec) -> int:
    """2 x the active weights of the products a token goes through (the
    embedding lookup and the head not included)."""
    return 2 * sum(_mixer_weights(spec, mx) + _ffn_active(spec, f)
                   for mx, f in spec.kinds)


def attention_flops(spec: ModelSpec, B: int, S: int) -> int:
    """Causal attention of one (B, S) prefill, every attention layer:
    2 B S^2 H hd a layer (the scores and the weighted values over the
    keys at or before each query)."""
    n_attn = sum(mx == "attn" for mx, _ in spec.kinds)
    return n_attn * 2 * B * S * S * spec.n_heads * spec.hd


def prefill_flops(spec: ModelSpec, B: int, S: int) -> int:
    """Model FLOPs of one (B, S) prefill call that returns the last
    position's logits."""
    return (token_flops(spec) * B * S + attention_flops(spec, B, S)
            + 2 * B * spec.d * spec.vocab)


def scan_bytes(spec: ModelSpec, B: int, S: int) -> int:
    """One Mamba scan call: dt and xc (B, S, d_inner) and B and C (B, S,
    d_state) read once in bfloat16, A (d_inner, d_state) float32 read
    once, y (B, S, d_inner) and the final state (B, d_inner, d_state)
    written once in float32."""
    m = spec.mamba
    di, n = m.d_inner, m.d_state
    return (2 * B * S * di * BF16 + 2 * B * S * n * BF16 + di * n * F32
            + B * S * di * F32 + B * di * n * F32)


def decode_flops(spec: ModelSpec, B: int, pos: int) -> int:
    """One decode step of B tokens at position ``pos`` (``pos`` keys
    before it in the cache)."""
    n_attn = sum(mx == "attn" for mx, _ in spec.kinds)
    attn = n_attn * 4 * B * (pos + 1) * spec.n_heads * spec.hd
    return token_flops(spec) * B + attn + 2 * B * spec.d * spec.vocab


def decode_bytes(spec: ModelSpec, B: int, pos: int) -> int:
    """One decode step's bytes (see the module docstring)."""
    d = spec.d
    w = B * d  # the embedding rows looked up
    w += d * spec.vocab  # the head
    state = 0
    for mx, ffn in spec.kinds:
        w += 2 * d  # the two norms
        if mx == "attn":
            w += _mixer_weights(spec, mx)
            kv = 2 * B * spec.n_kv * spec.hd
            state += kv * (pos + 1) * BF16  # K and V read, the new written
        else:
            m = spec.mamba
            w += _mixer_weights(spec, mx) + 3 * m.d_inner
            w += m.d_inner * m.d_state  # A_log
            conv = B * (m.d_conv - 1) * m.d_inner * BF16
            ssm = B * m.d_inner * m.d_state * F32
            state += 2 * (conv + ssm)
        if ffn == "mlp":
            w += 3 * d * spec.d_ff
        else:
            m = spec.moe
            w += d * m.padded + m.n_experts * 3 * d * m.d_ff
            w += 3 * d * m.shared_ff
    w += d  # the final norm
    return w * BF16 + state


def step_floor_s(spec: ModelSpec, B: int, pos: int) -> float:
    """The least time a decode step could take on the card."""
    return max(decode_flops(spec, B, pos) / PEAK_BF16_FLOPS,
               decode_bytes(spec, B, pos) / HBM_BYTES_S)
