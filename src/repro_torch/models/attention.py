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
causal/window mask (all ones for the encoder and cross-attention), in
query chunks where ``cfg.attn_chunk`` asks for them (:func:`_chunked_attn`),
on the card too; without grad the flash kernel already bounds the score
memory, so ``attn_chunk`` changes nothing there.  One-token decode, against the self-attention cache or the
precomputed cross K/V, stays ordinary torch ops (:func:`_grouped_attn`),
as it is jnp outside any kernel in the reference.

Tensor parallelism along ``"model"`` (:func:`~.common.model_axis`): when
a rank's ``wq`` holds fewer heads than the config (its slice, cut by
``transformer.shard_params``), the q, k and v projections are
column-parallel over its heads (the normed input enters through
``collectives.replicated_param``, whose backward sums the ranks' partial
input gradients), attention runs on the local heads (the flash kernel
unchanged) and ``wo`` is row-parallel, followed by
``collectives.reduce``.  Where the KV heads do not split but the q heads
do (2 KV heads on 4 ranks), each rank holds the whole ``wk`` and ``wv``
and uses the KV heads its q heads read; those weights, and the QK-norm
scales, enter through ``replicated_param``, so their gradient is summed
over ``"model"`` (each rank's holds only its heads' share).
Cross-attention follows the same pattern, its context entering as the
normed input does.

Caches under a mesh hold what the reference's cache rule gives a rank
(``("batch", "cache_seq", "kv_heads", None)``, Whisper's cross K/V
``("batch", "enc_seq", "kv_heads", None)``): where the sequence splits
over the active rules' cache axes (:func:`~.common.cache_axis`:
``"model"``, or ``("data", "model")`` under ``long_decode_rules``) a
rank holds every KV head for its own positions, a
:class:`SeqKVCache` (a ring cache is split by slot); else the KV heads
split over ``"model"`` where they divide, else whole.  The prefill still
runs the flash kernel on the local heads; one all-to-all per layer then
moves its K and V from the head split to the sequence split
(:func:`prefill_cache`).  Decode projects q, k and v column-parallel as
before, all-gathers the new token's q, k and v over ``"model"`` (a few
KB) where the cache's sequence lies along it, the rank owning the slot
writes k and v, each rank computes float32 partials (max, sum, output)
over its own keys under the reference's mask, a log-sum-exp over the
cache axes combines them, and the rank keeps its heads for the
row-parallel ``wo``.  Every collective goes through
``distributed.collectives``.

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
from ..distributed import collectives as coll
from ..kernels import ops
from .common import (ModelAxis, ParamSpec, SeqAxis, cache_axis, enter,
                     leave, model_axis, seq_axis)
from .layers import apply_mrope, apply_rope, rmsnorm

__all__ = ["attn_spec", "cross_attn_spec", "KVCache", "SeqSplit",
           "SeqKVCache", "local_heads", "init_cache", "prefill_cache",
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


class SeqSplit(NamedTuple):
    """How a :class:`SeqKVCache` is split: the mesh axes its sequence (or
    ring of slots) lies along and its whole length."""

    axes: Tuple[str, ...]
    length: int


class SeqKVCache(KVCache):
    """A KV cache split along its sequence: k, v (B, length / n, n_kv,
    hd) hold slots ``[index * length / n, (index + 1) * length / n)`` of
    the whole cache, every KV head, where ``n`` and ``index`` are the
    size of ``split.axes`` and this rank's index on them.  ``split``
    (a :class:`SeqSplit`) is an attribute, not a field, so the cache is
    the pair (k, v) to code that walks caches; a copy made field by
    field (``type(c)(*fields)``) loses it and is then read as whole."""

    def __new__(cls, k, v, split: Optional[SeqSplit] = None):
        self = super().__new__(cls, k, v)
        self.split = split
        return self

    def seq(self) -> Optional[SeqAxis]:
        """The split's axes on the active mesh."""
        split = getattr(self, "split", None)
        return None if split is None else seq_axis(split.axes)


def _seq_of(cache) -> Tuple[Optional[SeqAxis], int]:
    """(the cache's :class:`SeqAxis` or None, its whole length)."""
    ax = cache.seq() if isinstance(cache, SeqKVCache) else None
    return ax, (cache.k.shape[1] if ax is None else cache.split.length)


def _kv_range(nq: int, g: int, index: int) -> Tuple[int, int]:
    """(first, count) of the KV heads read by q heads ``[index * nq,
    (index + 1) * nq)`` with ``g`` q heads per KV head."""
    if nq % g and g % nq:
        raise ValueError(f"{nq} query heads a rank straddle groups of {g} "
                         f"query heads per KV head")
    return index * nq // g, max(nq // g, 1)


def local_heads(cfg: ModelConfig, model: int = 1) -> Tuple[int, int]:
    """A rank's (q heads, KV heads) with ``model`` ranks along
    ``"model"``: the heads split where they divide (the rules'
    divisibility policy), else whole; KV heads that do not divide while
    the q heads do are the ones this rank's q heads read."""
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    if model == 1 or nq % model:
        return nq, nkv
    if nkv % model == 0:
        return nq // model, nkv // model
    return nq // model, _kv_range(nq // model, nq // nkv, 0)[1]


def init_cache(cfg: Optional[ModelConfig], batch: int, max_len: int,
               window: Optional[int], dtype, device=None,
               n_kv: Optional[int] = None,
               hd: Optional[int] = None) -> KVCache:
    """An empty cache of ``n_kv`` heads of ``hd`` (default the
    config's)."""
    S = max_len if window is None else min(window, max_len)
    shape = (batch, S, n_kv or cfg.n_kv_heads, hd or cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _ring(k: torch.Tensor, v: torch.Tensor, window: Optional[int],
          max_len: int, dtype) -> KVCache:
    """The whole decode cache of K/V (B, S, n, hd) projected over S
    positions: ``max_len`` slots (slot i position i), or a ring of
    ``min(window, max_len)`` slots holding the last ones at ``pos %
    slots``."""
    B, S = k.shape[0], k.shape[1]
    cache = init_cache(None, B, max_len, window, dtype or k.dtype, k.device,
                       k.shape[2], k.shape[3])
    S_c = cache.k.shape[1]
    if window is None or S <= S_c:
        cache.k[:, :S] = k
        cache.v[:, :S] = v
        return cache
    start = S - S_c
    slots = (start + torch.arange(S_c, device=k.device)) % S_c
    cache.k[:, slots] = k[:, -S_c:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, -S_c:].to(cache.v.dtype)
    return cache


def _whole_kv(cfg: ModelConfig, params, x: torch.Tensor,
              positions: Optional[torch.Tensor]):
    """Every KV head's k and v from the rank's whole ``wk`` and ``wv`` (KV
    heads that do not split); with ``positions`` after the k-norm and
    RoPE, without (cross K/V) raw."""
    k, v = _proj(x, params["wk"]), _proj(x, params["wv"])
    if positions is not None:
        _, k = _qk_normed(cfg, params, None, k)
        if cfg.pos_embed == "rope":
            k = _rotate(cfg, k, positions)
    return k, v


def prefill_cache(cfg: ModelConfig, params, x: torch.Tensor,
                  positions: Optional[torch.Tensor], k: torch.Tensor,
                  v: torch.Tensor, window: Optional[int], max_len: int,
                  dtype=None, name: str = "cache_seq") -> KVCache:
    """One layer's decode cache from the K/V its prefill projected (this
    rank's KV heads), in the rank's layout (see the module docstring):
    ``name`` ``"cache_seq"`` for a self-attention cache of ``max_len``
    positions (a ring under ``window``), ``"enc_seq"`` for cross K/V
    (``max_len`` their length, ``positions`` None).  ``x`` is the
    projections' input, from which KV heads that do not split are
    projected whole."""
    mx = _split(cfg, params)
    L = max_len if window is None else min(window, max_len)
    seq = cache_axis(name, L)
    even = mx is not None and k.shape[2] * mx.size == cfg.n_kv_heads
    on_model = seq is not None and "model" in seq.axes
    if k.shape[2] < cfg.n_kv_heads and not even:  # replicated KV heads
        k, v = _whole_kv(cfg, params, x, positions)
    cache = (KVCache(k, v) if name == "enc_seq"
             else _ring(k, v, window, max_len, dtype))
    if seq is None:
        return cache
    n_loc = L // seq.size
    kv = torch.stack(cache)  # (2, B, L, n, hd)
    if on_model and even:  # head split -> sequence split: one all-to-all
        if seq.axes[-1] != "model":
            raise ValueError(f"cache axes {seq.axes}: model must be minor")
        M = mx.size
        slab = seq.index // M * M * n_loc
        kv = kv[:, :, slab:slab + M * n_loc].unflatten(2, (M, n_loc))
        got = coll.all_to_all(kv.movedim(2, 0).contiguous(), mx.group)
        kv = got.permute(1, 2, 3, 0, 4, 5).flatten(3, 4)
    else:  # every rank holds these heads: keep its positions
        kv = kv[:, :, seq.index * n_loc:(seq.index + 1) * n_loc].clone()
    return SeqKVCache(kv[0], kv[1], SeqSplit(seq.axes, L))


def _split(cfg: ModelConfig, params) -> Optional[ModelAxis]:
    """The ``"model"`` axis when this layer's heads are split over it."""
    ax = model_axis()
    if ax is None or params["wq"].shape[1] == cfg.n_heads:
        return None
    return ax


def _kv_weights(cfg: ModelConfig, params, ax: Optional[ModelAxis]):
    """``wk`` and ``wv`` for this rank's heads."""
    wk, wv = params["wk"], params["wv"]
    if ax is None or wk.shape[1] < cfg.n_kv_heads:
        return wk, wv
    first, n = _kv_range(params["wq"].shape[1],
                         cfg.n_heads // cfg.n_kv_heads, ax.index)
    return (enter(wk, ax)[:, first:first + n],
            enter(wv, ax)[:, first:first + n])


def _qk_normed(cfg: ModelConfig, params, q, k,
               ax: Optional[ModelAxis] = None):
    if cfg.qk_norm:
        if q is not None:
            q = rmsnorm({"scale": enter(params["q_norm"]["scale"], ax)}, q,
                        cfg.norm_eps)
        if k is not None:
            k = rmsnorm({"scale": enter(params["k_norm"]["scale"], ax)}, k,
                        cfg.norm_eps)
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
    for (B, 3, S) positions); this rank's heads under a split."""
    ax = _split(cfg, params)
    x = enter(x, ax)
    wk, wv = _kv_weights(cfg, params, ax)
    q = _proj(x, params["wq"])
    k = _proj(x, wk)
    v = _proj(x, wv)
    q, k = _qk_normed(cfg, params, q, k, ax)
    if cfg.pos_embed == "rope":
        q = _rotate(cfg, q, positions)
        k = _rotate(cfg, k, positions)
    return q, k, v


def project_cross_kv(cfg: ModelConfig, params, ctx_k: torch.Tensor,
                     ctx_v: torch.Tensor):
    """Cross-attention's k and v (B,T,nkv,hd) projected from the context:
    no norm and no RoPE (the products the reference's
    ``_precompute_cross_kv_all`` caches); this rank's heads under a
    split."""
    ax = _split(cfg, params)
    wk, wv = _kv_weights(cfg, params, ax)
    return _proj(enter(ctx_k, ax), wk), _proj(enter(ctx_v, ax), wv)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bsnh,nhd->bsd")``."""
    n, h, d = wo.shape
    return out.flatten(-2) @ wo.reshape(n * h, d)


def _out(cfg: ModelConfig, params, out: torch.Tensor) -> torch.Tensor:
    """The output projection, summed over ``"model"`` under a split
    (row-parallel ``wo``)."""
    return leave(_out_proj(out, params["wo"]), _split(cfg, params))


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
    return _out(cfg, params, out)


def train_attention(cfg: ModelConfig, q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    pos_offset: int = 0) -> torch.Tensor:
    """The reference's differentiable full-sequence attention
    (``repro.models.attention.attention``): query chunks of
    ``cfg.attn_chunk`` (:func:`_chunked_attn`) when the query length ``S``
    exceeds it and is a multiple of it, else :func:`_grouped_attn` under
    the whole causal and sliding-window mask.  As in the reference,
    ``pos_offset`` shifts both the query and the key positions of the
    whole mask (where it cancels) and only the query positions of a
    chunk's mask."""
    S, T = q.shape[1], k.shape[1]
    chunk = cfg.attn_chunk
    if chunk is not None and S > chunk and S % chunk == 0:
        return _chunked_attn(cfg, q, k, v, chunk, causal=causal,
                             window=window, pos_offset=pos_offset)
    if causal:
        qp = torch.arange(S, device=q.device)[:, None] + pos_offset
        kp = torch.arange(T, device=q.device)[None, :] + pos_offset
        mask = qp >= kp
        if window is not None:
            mask &= qp - kp < window
    else:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    return _grouped_attn(cfg, q, k, v, mask)


def _chunked_attn(cfg: ModelConfig, q, k, v, chunk: int, *, causal: bool,
                  window: Optional[int], pos_offset: int) -> torch.Tensor:
    """Exact attention in query chunks: each chunk's (chunk x T) scores
    under the causal, window and ``pos_offset`` mask through
    :func:`_grouped_attn`, the outputs concatenated in order (the
    reference's ``lax.scan`` as a Python loop).  In a forward pass the
    score temporaries are bounded to one chunk's.  Under
    :func:`~repro_torch.models.transformer.forward_train`'s per-period
    ``torch.utils.checkpoint`` each chunk's scores are recomputed in the
    backward pass, as the reference's are under ``jax.checkpoint``."""
    S, T = q.shape[1], k.shape[1]
    kp = torch.arange(T, device=q.device)[None, :]
    rows = torch.arange(chunk, device=q.device)[:, None] + pos_offset
    outs = []
    for i in range(S // chunk):
        if causal:
            qp = rows + i * chunk
            mask = qp >= kp
            if window is not None:
                mask &= qp - kp < window
        else:
            mask = torch.ones((chunk, T), dtype=torch.bool, device=q.device)
        outs.append(_grouped_attn(cfg, q[:, i * chunk:(i + 1) * chunk],
                                  k, v, mask))
    return torch.cat(outs, dim=1)


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
                               *project_cross_kv(cfg, params, *kv))
    q, k, v = project_qkv(cfg, params, x, positions)
    if not causal:
        window = None
    return attend(cfg, params, q, k, v, causal=causal, window=window)


def cross_attention(cfg: ModelConfig, params, x: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full-sequence cross-attention of ``x`` (B,S,d) against the context's
    projected k and v (:func:`project_cross_kv`): QK-norm on q and k, no
    RoPE, every key visible (the flash kernel with ``causal=False``)."""
    ax = _split(cfg, params)
    q, k = _qk_normed(cfg, params, _proj(enter(x, ax), params["wq"]), k,
                      ax)
    return attend(cfg, params, q, k, v, causal=False)


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _grouped_attn(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """q: (B,S,nq,hd); k,v: (B,T,nkv,hd) (a rank's heads under a split);
    mask broadcastable to (B,nkv,g,S,T).  Repeated KV heads are never
    materialized."""
    B, S, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = q.reshape(B, S, nkv, g, hd)
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype)
    scores = torch.einsum("bsngh,btnh->bngst", qg * scale, k)
    scores = _softcap(scores.to(f32), cfg.attn_softcap)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnh->bsngh", w, v)
    return out.reshape(B, S, nq, hd)


def _partials(cfg: ModelConfig, q, k, v, mask):
    """Attention of q (B,S,nq,hd) over these keys only, as float32
    partials: the scores' max (B,nkv,g,S,1), the sum of their exponentials
    after it and the weighted values (B,nkv,g,S,hd)."""
    B, S, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, S, nkv, nq // nkv, hd)
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype)
    scores = torch.einsum("bsngh,btnh->bngst", qg * scale, k)
    scores = _softcap(scores.to(f32), cfg.attn_softcap)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    o = torch.einsum("bngst,btnh->bngsh", p, v.to(f32))
    return m, p.sum(-1, keepdim=True), o


def _combined(cfg: ModelConfig, q, k, v, mask,
              seq: SeqAxis) -> torch.Tensor:
    """Attention of q over the keys that the ranks of ``seq`` hold: each
    rank's float32 partials, combined by a log-sum-exp over the group;
    (B,S,nq,hd) in q's dtype."""
    m, l, o = _partials(cfg, q, k, v, mask)
    m_all = coll.all_reduce_max(m, seq.group)
    w = torch.exp(m - m_all)
    lo = coll.all_reduce_sum(torch.cat([l * w, o * w], -1), seq.group)
    out = lo[..., 1:] / lo[..., :1]  # (B, nkv, g, S, hd)
    B, nkv, g, S, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, nkv * g, hd).to(q.dtype)


def _gather_heads(ts, ax: ModelAxis):
    """Tensors (B, 1, n_i, hd) of this rank's heads put together over
    ``"model"`` (one all-gather): every rank's heads, in order."""
    B, _, _, hd = ts[0].shape
    sizes = [t.shape[2] for t in ts]
    got = coll.all_gather(torch.cat(ts, 2), ax.group)  # (M*B, 1, sum, hd)
    got = got.view(ax.size, B, 1, sum(sizes), hd)
    return [p.movedim(0, 2).flatten(2, 3)
            for p in got.split(sizes, dim=3)]


def _attend_cache(cfg: ModelConfig, params, x, q, k, v, cache: KVCache,
                  seq: Optional[SeqAxis], mask, write, positions):
    """Decode attention of the rank's q (B,1,nq_loc,hd) against ``cache``
    in its layout (see the module docstring), after ``write(k, v)`` puts
    the new token's K/V (None: cross K/V, nothing written); the output
    of the rank's q heads."""
    mx = _split(cfg, params)
    nq_loc = q.shape[2]
    all_heads = cache.k.shape[2] == cfg.n_kv_heads
    if all_heads and k is not None and k.shape[2] < cfg.n_kv_heads:
        if mx is not None and k.shape[2] * mx.size == cfg.n_kv_heads:
            # heads split evenly, cache along the sequence over "model"
            q, k, v = _gather_heads([q, k, v], mx)
        else:  # replicated KV heads: project them all
            k, v = _whole_kv(cfg, params, x, positions)
    if mx is not None and all_heads and seq is not None \
            and "model" in seq.axes and q.shape[2] == nq_loc:
        q, = _gather_heads([q], mx)
    if write is not None:
        write(k, v)
    ck, cv = cache.k.to(q.dtype), cache.v.to(q.dtype)
    if all_heads and q.shape[2] < cfg.n_heads:  # the KV heads q reads
        first, n = _kv_range(nq_loc, cfg.n_heads // cfg.n_kv_heads,
                             mx.index)
        ck, cv = ck[:, :, first:first + n], cv[:, :, first:first + n]
    if seq is None:
        # a cache kept in another dtype (bfloat16 beside float32 weights,
        # as the step builders' prefill writes it) is read in q's, as the
        # reference's einsum promotes it
        return _grouped_attn(cfg, q, ck, cv, mask)
    out = _combined(cfg, q, ck, cv, mask, seq)
    if out.shape[2] > nq_loc:  # keep this rank's heads
        out = out[:, :, mx.index * nq_loc:(mx.index + 1) * nq_loc]
    return out


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
    otherwise RoPE at ``pos``.  A :class:`SeqKVCache` is read as the
    module docstring says."""
    B = x.shape[0]
    if cfg.mrope_sections is not None and positions is not None:
        p = positions
    else:
        p = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = project_qkv(cfg, params, x, p)
    seq, S_cache = _seq_of(cache)
    n_loc = cache.k.shape[1]
    first = 0 if seq is None else seq.index * n_loc
    slot = pos % S_cache if window is not None else pos

    def write(k, v):
        if first <= slot < first + n_loc:  # this rank holds the slot
            cache.k[:, slot - first] = k[:, 0].to(cache.k.dtype)
            cache.v[:, slot - first] = v[:, 0].to(cache.v.dtype)

    # Valid slots: global cache -> positions <= pos; ring cache -> the
    # window positions (pos-window, pos], which is every written slot.
    idx = first + torch.arange(n_loc, device=x.device)
    if window is None:
        mask = idx <= pos
    else:
        # slot j holds position p_j = pos - ((slot - j) % S_cache)
        back = (slot - idx) % S_cache
        p_j = pos - back
        mask = (p_j >= 0) & (pos - p_j < S_cache)
    xe = enter(x, _split(cfg, params))
    out = _attend_cache(cfg, params, xe, q, k, v, cache, seq, mask, write, p)
    return _out(cfg, params, out), cache


def decode_cross_attention(cfg: ModelConfig, params, x: torch.Tensor,
                           cross_k: torch.Tensor, cross_v: torch.Tensor,
                           cache: Optional[KVCache] = None) -> torch.Tensor:
    """Decoder cross-attention of ``x`` (B,1,d) against precomputed encoder
    K/V: q-norm on q, every key visible (:func:`_grouped_attn`, as the
    reference's jnp); ``cache``, when given, the :class:`KVCache` (or
    :class:`SeqKVCache`) holding them, in the rank's layout."""
    ax = _split(cfg, params)
    q, _ = _qk_normed(cfg, params, _proj(enter(x, ax), params["wq"]), None,
                      ax)
    seq = _seq_of(cache)[0] if cache is not None else None
    mask = torch.ones((x.shape[1], cross_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _attend_cache(cfg, params, None, q, None, None,
                        KVCache(cross_k, cross_v), seq, mask, None, None)
    return _out(cfg, params, out)


def precompute_cross_kv(cfg: ModelConfig, params, enc_out: torch.Tensor):
    """One layer's cross K/V from the encoder output, k-normed where the
    config has QK-norm (the reference's ``precompute_cross_kv``; the
    stack's prefill caches :func:`project_cross_kv`'s, without the norm,
    as the reference's ``_precompute_cross_kv_all`` does)."""
    ax = _split(cfg, params)
    k, v = project_cross_kv(cfg, params, enc_out, enc_out)
    if ax is not None and k.shape[2] * ax.size != cfg.n_kv_heads:
        k, v = _whole_kv(cfg, params, enc_out, None)  # every KV head
    _, k = _qk_normed(cfg, params, None, k, ax)
    c = prefill_cache(cfg, params, enc_out, None, k, v, None,
                      enc_out.shape[1], name="enc_seq")
    return c.k, c.v
