"""GQA attention with RoPE / M-RoPE, softcap, sliding window, KV caches
and cross-attention.

Counterpart of ``repro.models.attention``.  The reference's docstring says
the stack can route prefill through the flash kernel, and that on the
accelerator the kernel replaces its jnp path; the port does that: full-
sequence attention without autograd (prefill, the encoder and the
prefill's cross-attention) calls
:func:`repro_torch.kernels.ops.flash_attention`, which launches the
hand-written CUDA kernel on the card and takes its plain PyTorch version
on the CPU.  That one call replaces the reference's ``_grouped_attn`` and
``_chunked_attn`` for prefill.  The kernel has no backward (nor has the
reference's Pallas kernel), so when autograd records (training) the
reference's training math runs instead: :func:`_grouped_attn` under the
causal/window mask (all ones for the encoder and cross-attention), on the
card too.  One-token decode, against the self-attention cache or the
precomputed cross K/V, stays ordinary torch ops (:func:`_grouped_attn`),
as it is jnp outside any kernel in the reference.

Sliding-window ("local") layers keep a ring-buffer KV cache of ``window``
slots.  Decode writes the new token's K/V into the cache tensors in place
(the reference returns updated copies); the caller hands the same cache to
the next step.  Qwen2-VL's M-RoPE takes (B, 3, S) position ids (t, h, w);
in decode they come apart from the cache index after a vision block.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .common import ParamSpec
from .layers import apply_mrope, apply_rope, rmsnorm

__all__ = ["attn_spec", "cross_attn_spec", "KVCache", "init_cache",
           "project_qkv", "project_cross_kv", "attend", "train_attention",
           "attention", "cross_attention", "decode_attention",
           "decode_cross_attention", "precompute_cross_kv"]

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


def cross_attn_spec(cfg: ModelConfig) -> Dict:
    return attn_spec(cfg)


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


def _rotate(cfg: ModelConfig, t: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """RoPE, or M-RoPE where the config has sections and ``positions`` is
    (B, 3, S); (B, 3, S) positions without sections rotate by t."""
    if cfg.mrope_sections is not None and positions.ndim == 3:
        return apply_mrope(t, positions, cfg.rope_theta, cfg.mrope_sections)
    pos = positions if positions.ndim == 2 else positions[:, 0]
    return apply_rope(t, pos, cfg.rope_theta)


def project_qkv(cfg: ModelConfig, params, x: torch.Tensor,
                positions: torch.Tensor):
    """q (B,S,nq,hd), k and v (B,S,nkv,hd) after QK-norm and RoPE (M-RoPE
    for (B, 3, S) positions)."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    q, k = _qk_normed(cfg, params, q, k)
    if cfg.pos_embed == "rope":
        q = _rotate(cfg, q, positions)
        k = _rotate(cfg, k, positions)
    return q, k, v


def project_cross_kv(params, ctx_k: torch.Tensor, ctx_v: torch.Tensor):
    """Cross-attention's k and v (B,T,nkv,hd) projected from the context:
    no norm and no RoPE (the products the reference's
    ``_precompute_cross_kv_all`` caches)."""
    return _proj(ctx_k, params["wk"]), _proj(ctx_v, params["wv"])


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bsnh,nhd->bsd")``."""
    n, h, d = wo.shape
    return out.flatten(-2) @ wo.reshape(n * h, d)


def attend(cfg: ModelConfig, params, q, k, v, *, causal: bool = True,
           window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention of projected q/k/v, then the output
    projection: through the flash kernel wrapper, or, when autograd
    records a graph through q, k or v, through the reference's training
    math (:func:`train_attention`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = train_attention(cfg, q, k, v, causal=causal, window=window)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=cfg.attn_softcap)
    return _out_proj(out, params["wo"])


def train_attention(cfg: ModelConfig, q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """The reference's differentiable full-sequence attention
    (``repro.models.attention.attention`` without ``attn_chunk``):
    :func:`_grouped_attn` under the causal and sliding-window mask."""
    if cfg.attn_chunk is not None:
        raise NotImplementedError(
            "query-chunked training attention (attn_chunk) is not ported "
            "yet: ROADMAP.md item 1.7i")
    S, T = q.shape[1], k.shape[1]
    if causal:
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(T, device=q.device)[None, :]
        mask = qp >= kp
        if window is not None:
            mask &= qp - kp < window
    else:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    return _grouped_attn(cfg, q, k, v, mask)


def attention(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross
) -> torch.Tensor:
    """Full-sequence attention (training, prefill, the encoder and
    cross-attention).  Non-causal and cross-attention see every key, as
    the reference's all-ones mask does (no window)."""
    if kv is not None:
        return cross_attention(cfg, params, x,
                               *project_cross_kv(params, *kv))
    q, k, v = project_qkv(cfg, params, x, positions)
    if not causal:
        window = None
    return attend(cfg, params, q, k, v, causal=causal, window=window)


def cross_attention(cfg: ModelConfig, params, x: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full-sequence cross-attention of ``x`` (B,S,d) against the context's
    projected k and v (:func:`project_cross_kv`): QK-norm on q and k, no
    RoPE, every key visible (the flash kernel with ``causal=False``)."""
    q, k = _qk_normed(cfg, params, _proj(x, params["wq"]), k)
    return attend(cfg, params, q, k, v, causal=False)


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
    positions: Optional[torch.Tensor] = None,  # (B, 3, 1) for M-RoPE
) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode against a (ring-buffer) KV cache, updated in
    place.  With M-RoPE sections, ``positions`` (B, 3, 1) rotate q and k
    (they differ from the cache index ``pos`` after a vision block);
    otherwise RoPE at ``pos``."""
    B = x.shape[0]
    if cfg.mrope_sections is not None and positions is not None:
        p = positions
    else:
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


def decode_cross_attention(cfg: ModelConfig, params, x: torch.Tensor,
                           cross_k: torch.Tensor,
                           cross_v: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention of ``x`` (B,1,d) against precomputed encoder
    K/V: q-norm on q, every key visible (:func:`_grouped_attn`, as the
    reference's jnp)."""
    q = _proj(x, params["wq"])
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
    mask = torch.ones((x.shape[1], cross_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _grouped_attn(cfg, q, cross_k, cross_v, mask)
    return _out_proj(out, params["wo"])


def precompute_cross_kv(cfg: ModelConfig, params, enc_out: torch.Tensor):
    """One layer's cross K/V from the encoder output, k-normed where the
    config has QK-norm (the reference's ``precompute_cross_kv``; the
    stack's prefill caches :func:`project_cross_kv`'s, without the norm,
    as the reference's ``_precompute_cross_kv_all`` does)."""
    k, v = project_cross_kv(params, enc_out, enc_out)
    if cfg.qk_norm:
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return k, v
