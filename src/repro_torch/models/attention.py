"""GQA attention with RoPE, softcap, sliding window and KV caches.

Counterpart of ``repro.models.attention`` for the dense decoders.  The
reference's docstring says the stack can route prefill through the flash
kernel, and that on the accelerator the kernel replaces its jnp path; the
port does that: full-sequence attention (prefill) calls
:func:`repro_torch.kernels.ops.flash_attention`, which launches the
hand-written CUDA kernel on the card and takes its plain PyTorch version
on the CPU.  That one call replaces the reference's ``_grouped_attn`` and
``_chunked_attn`` for prefill.  One-token decode stays ordinary torch ops
(:func:`_grouped_attn`), as it is jnp outside any kernel in the reference.

Sliding-window ("local") layers keep a ring-buffer KV cache of ``window``
slots.  Decode writes the new token's K/V into the cache tensors in place
(the reference returns updated copies); the caller hands the same cache to
the next step.  Cross-attention (encoder-decoder) and M-RoPE are not
ported (ROADMAP.md items 1.7e and 1.7f).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .common import ParamSpec
from .layers import apply_rope, rmsnorm

__all__ = ["attn_spec", "KVCache", "init_cache", "project_qkv", "attend",
           "attention", "decode_attention"]

f32 = torch.float32
NEG_INF = -2.0e38


def attn_spec(cfg: ModelConfig) -> Dict:
    d, nq, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {
        "wq": ParamSpec((d, nq, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((nq, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = {"scale": ParamSpec((hd,), (None,), init="zeros")}
        s["k_norm"] = {"scale": ParamSpec((hd,), (None,), init="zeros")}
    return s


class KVCache(NamedTuple):
    """Ring-buffer KV cache.

    k, v: (B, S_cache, n_kv, hd).  For global layers S_cache = max_len and
    slot i holds position i.  For local layers S_cache = window and slot
    ``pos % window`` holds position pos (older entries are overwritten).
    """

    k: torch.Tensor
    v: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: Optional[int], dtype, device=None) -> KVCache:
    S = max_len if window is None else min(window, max_len)
    shape = (batch, S, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _qk_normed(cfg: ModelConfig, params, q, k):
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return q, k


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dnh->bsnh")`` as one matmul on the flattened heads."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).unflatten(-1, (n, h))


def project_qkv(cfg: ModelConfig, params, x: torch.Tensor,
                positions: torch.Tensor):
    """q (B,S,nq,hd), k and v (B,S,nkv,hd) after QK-norm and RoPE."""
    if positions.ndim != 2:
        raise NotImplementedError(
            "M-RoPE positions are not ported yet: ROADMAP.md item 1.7f")
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    q, k = _qk_normed(cfg, params, q, k)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bsnh,nhd->bsd")``."""
    n, h, d = wo.shape
    return out.flatten(-2) @ wo.reshape(n * h, d)


def attend(cfg: ModelConfig, params, q, k, v, *, causal: bool = True,
           window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention of projected q/k/v through the flash
    kernel wrapper, then the output projection."""
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_softcap)
    return _out_proj(out, params["wo"])


def attention(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Full-sequence self-attention (prefill)."""
    if kv is not None:
        raise NotImplementedError(
            "cross-attention is not ported yet: ROADMAP.md item 1.7e")
    q, k, v = project_qkv(cfg, params, x, positions)
    return attend(cfg, params, q, k, v, causal=causal, window=window)


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _grouped_attn(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """q: (B,S,nq,hd); k,v: (B,T,nkv,hd); mask broadcastable to
    (B,nkv,g,S,T).  Repeated KV heads are never materialized."""
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    g = nq // nkv
    B, S = q.shape[0], q.shape[1]
    qg = q.reshape(B, S, nkv, g, cfg.hd)
    scale = torch.tensor(cfg.hd ** -0.5, dtype=q.dtype)
    scores = torch.einsum("bsngh,btnh->bngst", qg * scale, k)
    scores = _softcap(scores.to(f32), cfg.attn_softcap)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnh->bsngh", w, v)
    return out.reshape(B, S, nq, cfg.hd)


def decode_attention(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,  # (B, 1, d)
    cache: KVCache,
    pos: int,  # index of the new token
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode against a (ring-buffer) KV cache, updated in
    place."""
    B = x.shape[0]
    p = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = project_qkv(cfg, params, x, p)
    S_cache = cache.k.shape[1]
    slot = pos % S_cache if window is not None else pos
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    # Valid slots: global cache -> positions <= pos; ring cache -> the
    # window positions (pos-window, pos], which is every written slot.
    idx = torch.arange(S_cache, device=x.device)
    if window is None:
        mask = idx <= pos
    else:
        # slot j holds position p_j = pos - ((slot - j) % S_cache)
        back = (slot - idx) % S_cache
        p_j = pos - back
        mask = (p_j >= 0) & (pos - p_j < S_cache)
    out = _grouped_attn(cfg, q, cache.k, cache.v, mask)
    return _out_proj(out, params["wo"]), cache
