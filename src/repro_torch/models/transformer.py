"""The decoder stack and its serving passes (prefill, decode).

Counterpart of the dense parts of ``repro.models.transformer``.  The
reference scans a repeating *period* of (mixer, ffn) sublayers over
stacked parameters, plus an unscanned remainder; the scan, remat and the
loop barrier exist for XLA.  Here the stack is a :class:`DecoderLM`
holding one :class:`Sublayer` module per layer, in order (period 0's
sublayers, period 1's, ..., then the remainder), each with the reference's
parameter shapes and keys, and the passes are a Python loop over them.

Two entry modes share one sublayer implementation:
  * ``prefill``     — full-sequence forward that also emits decode caches
    (attention through the flash kernel wrapper),
  * ``decode_step`` — one token against the caches (updated in place).

Only the dense decoders are ported: attention/local mixers and mlp (or
no) FFNs.  Mamba, mLSTM/sLSTM, MoE, encoder-decoder and vision configs
raise ``NotImplementedError`` naming their ROADMAP.md item, and
``forward_train``/``lm_loss`` wait for the training slice (item 1.7a).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..configs.base import ModelConfig, Sublayer as SublayerKind
from . import attention as attn_mod
from .attention import KVCache
from .common import ParamTree, materialize, stack_specs
from .layers import (
    embed,
    embed_spec,
    logits as compute_logits,
    mlp,
    mlp_spec,
    rmsnorm,
    rmsnorm_spec,
)

__all__ = ["check_ported", "sublayer_spec", "model_spec", "Sublayer",
           "DecoderLM", "layer_kinds", "init_params", "init_caches",
           "apply_sublayer_full", "apply_sublayer_decode", "prefill",
           "decode_step"]

#: the ROADMAP.md item of each mixer / ffn kind the port does not carry
_UNPORTED_MIXERS = {"mamba": "1.7c (Mamba)", "mlstm": "1.7d (xLSTM)",
                    "slstm": "1.7d (xLSTM)"}
_UNPORTED_FFNS = {"moe": "1.7b (MoE)"}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP.md item) unless
    ``cfg`` is a dense decoder the port carries."""
    for mixer, ffn in cfg.period:
        if mixer in _UNPORTED_MIXERS:
            raise NotImplementedError(
                f"{mixer} mixers are not ported yet: ROADMAP.md item "
                f"{_UNPORTED_MIXERS[mixer]}")
        if ffn in _UNPORTED_FFNS:
            raise NotImplementedError(
                f"{ffn} FFNs are not ported yet: ROADMAP.md item "
                f"{_UNPORTED_FFNS[ffn]}")
        if mixer not in ("attn", "local") or ffn not in ("mlp", "none"):
            raise ValueError(f"unknown sublayer {(mixer, ffn)}")
    if cfg.kind == "encdec" or cfg.pos_embed != "rope":
        raise NotImplementedError(
            "encoder-decoder models are not ported yet: ROADMAP.md item "
            "1.7e")
    if cfg.vision_stub or cfg.mrope_sections is not None:
        raise NotImplementedError(
            "vision-language models are not ported yet: ROADMAP.md item "
            "1.7f")


# --------------------------------------------------------------------- #
# Parameter specs
# --------------------------------------------------------------------- #
def sublayer_spec(cfg: ModelConfig, sub: SublayerKind) -> Dict:
    _, ffn = sub
    s: Dict = {
        "norm1": rmsnorm_spec(cfg.d_model),
        "mixer": attn_mod.attn_spec(cfg),
    }
    if ffn == "mlp":
        s["norm2"] = rmsnorm_spec(cfg.d_model)
        s["ffn"] = mlp_spec(cfg)
    return s


def model_spec(cfg: ModelConfig) -> Dict:
    """The reference's parameter tree: ``embed``, ``final_norm``, the
    period stacked over ``n_periods`` under ``stack`` and the remainder
    under ``rest``."""
    check_ported(cfg)
    s: Dict = {"embed": embed_spec(cfg), "final_norm": rmsnorm_spec(cfg.d_model)}
    if cfg.n_periods > 0:
        s["stack"] = stack_specs(
            {str(i): sublayer_spec(cfg, sub) for i, sub in enumerate(cfg.period)},
            cfg.n_periods)
    s["rest"] = {
        str(i): sublayer_spec(cfg, sub) for i, sub in enumerate(cfg.remainder)
    }
    return s


def layer_kinds(cfg: ModelConfig) -> List[SublayerKind]:
    """The (mixer, ffn) of every layer, in order."""
    return list(cfg.period) * cfg.n_periods + list(cfg.remainder)


# --------------------------------------------------------------------- #
# Modules
# --------------------------------------------------------------------- #
class Sublayer(ParamTree):
    """One (mixer, ffn) layer: ``norm1``, ``mixer`` (wq, wk, wv, wo and
    the optional q/k norms), and for mlp layers ``norm2`` and ``ffn``."""

    def __init__(self, kind: SublayerKind, tree: Dict):
        super().__init__(tree)
        self.kind = tuple(kind)


class DecoderLM(nn.Module):
    """The parameters of a dense decoder: ``embed``, ``layers`` (one
    :class:`Sublayer` per layer, in order) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, embed_tree: Dict,
                 layer_trees: Sequence[Dict], final_norm_tree: Dict):
        super().__init__()
        check_ported(cfg)
        kinds = layer_kinds(cfg)
        if len(layer_trees) != len(kinds):
            raise ValueError(f"{cfg.name}: expected {len(kinds)} layers, "
                             f"got {len(layer_trees)}")
        self.cfg = cfg
        self.embed = ParamTree(embed_tree)
        self.layers = nn.ModuleList(
            Sublayer(kind, t) for kind, t in zip(kinds, layer_trees))
        self.final_norm = ParamTree(final_norm_tree)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                dtype=None, device=None) -> DecoderLM:
    """Random parameters from ``generator`` (seed 0 on ``device`` when
    None), drawn layer by layer on ``device`` (None: the card): the
    embedding first, then each layer, then the final norm."""
    check_ported(cfg)
    device = resolve_device(device)
    dt = dtype or getattr(torch, cfg.param_dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=generator, device=device, dtype=dt)
    emb = materialize(embed_spec(cfg), **kw)
    layers = [materialize(sublayer_spec(cfg, sub), **kw)
              for sub in layer_kinds(cfg)]
    final = materialize(rmsnorm_spec(cfg.d_model), **kw)
    return DecoderLM(cfg, emb, layers, final)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device=None) -> List[KVCache]:
    """One empty KV cache per layer (ring buffers for local layers) on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    return [attn_mod.init_cache(cfg, batch, max_len,
                                cfg.window if mixer == "local" else None,
                                dtype, device)
            for mixer, _ in layer_kinds(cfg)]


# --------------------------------------------------------------------- #
# Sublayer application
# --------------------------------------------------------------------- #
def _apply_ffn(cfg, params, sub, x):
    if sub[1] == "none":
        return x
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + mlp(params["ffn"], h, cfg.ffn_act)


def apply_sublayer_full(
    cfg: ModelConfig, params, sub: SublayerKind, x: torch.Tensor,
    positions: torch.Tensor, *, causal: bool = True,
    collect_cache: bool = False, max_len: int = 0, cache_dtype=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full-sequence sublayer (prefill); the K/V it projects also fill the
    decode cache, so they are computed once (the reference projects them
    a second time for the cache, with the same result)."""
    mixer, _ = sub
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    window = cfg.window if mixer == "local" else None
    q, k, v = attn_mod.project_qkv(cfg, params["mixer"], h, positions)
    out = attn_mod.attend(cfg, params["mixer"], q, k, v, causal=causal,
                          window=window)
    new_cache = None
    if collect_cache:
        new_cache = _prefill_kv_cache(cfg, k, v, window, max_len, cache_dtype)
    x = x + out
    return _apply_ffn(cfg, params, sub, x), new_cache


def apply_sublayer_decode(
    cfg: ModelConfig, params, sub: SublayerKind, x: torch.Tensor,
    cache: KVCache, pos: int,
) -> Tuple[torch.Tensor, KVCache]:
    """One-token sublayer against its cache."""
    mixer, _ = sub
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    window = cfg.window if mixer == "local" else None
    out, new_cache = attn_mod.decode_attention(
        cfg, params["mixer"], h, cache, pos, window=window)
    x = x + out
    return _apply_ffn(cfg, params, sub, x), new_cache


def _prefill_kv_cache(cfg, k, v, window, max_len, dtype) -> KVCache:
    """The decode cache of one layer from its prefill K/V (after RoPE)."""
    B, S = k.shape[0], k.shape[1]
    cache = attn_mod.init_cache(cfg, B, max_len, window, dtype or k.dtype,
                                k.device)
    S_c = cache.k.shape[1]
    if window is None or S <= S_c:
        cache.k[:, :S] = k
        cache.v[:, :S] = v
        return cache
    # ring: keep the last S_c positions at slots pos % S_c
    start = S - S_c
    slots = (start + torch.arange(S_c, device=k.device)) % S_c
    cache.k[:, slots] = k[:, -S_c:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, -S_c:].to(cache.v.dtype)
    return cache


# --------------------------------------------------------------------- #
# Full model passes
# --------------------------------------------------------------------- #
def _input_embed(cfg: ModelConfig, params: DecoderLM,
                 batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, positions)."""
    tokens = batch["tokens"]
    x = embed(params.embed, cfg, tokens)
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    return x, positions


def _run_stack(cfg, params: DecoderLM, x, positions, *, causal=True,
               collect_cache=False, max_len=0, cache_dtype=None):
    """Every layer in order.  Returns (x, caches or None)."""
    caches = []
    for layer in params.layers:
        x, c = apply_sublayer_full(
            cfg, layer, layer.kind, x, positions, causal=causal,
            collect_cache=collect_cache, max_len=max_len,
            cache_dtype=cache_dtype)
        caches.append(c)
    return x, (caches if collect_cache else None)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: DecoderLM, batch: Dict, max_len: int,
            cache_dtype=None):
    """Full forward emitting the last position's logits (B, 1, vocab) and
    one decode cache per layer."""
    x, positions = _input_embed(cfg, params, batch)
    x, caches = _run_stack(
        cfg, params, x, positions, causal=True, collect_cache=True,
        max_len=max_len, cache_dtype=cache_dtype or x.dtype)
    x = rmsnorm(params.final_norm, x[:, -1:, :], cfg.norm_eps)
    return compute_logits(params.embed, cfg, x), caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: DecoderLM, caches: List[KVCache],
                tokens: torch.Tensor, pos: int):
    """One-token step.  tokens: (B, 1); pos: the current index.  The caches
    are updated in place and returned."""
    x = embed(params.embed, cfg, tokens)
    new_caches = []
    for layer, cache in zip(params.layers, caches):
        x, c = apply_sublayer_decode(cfg, layer, layer.kind, x, cache, pos)
        new_caches.append(c)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return compute_logits(params.embed, cfg, x), new_caches
