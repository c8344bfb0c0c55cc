"""The decoder stack: its training pass and its serving passes.

Counterpart of the decoder parts of ``repro.models.transformer``.  The
reference scans a repeating *period* of (mixer, ffn) sublayers over
stacked parameters, plus an unscanned remainder; the scan, remat and the
loop barrier exist for XLA.  Here the stack is a :class:`DecoderLM`
holding one :class:`Sublayer` module per layer, in order (period 0's
sublayers, period 1's, ..., then the remainder), each with the reference's
parameter shapes and keys, and the passes are a Python loop over them.

Three entry modes share one sublayer implementation:
  * ``forward_train`` — full-sequence teacher forcing (float32 logits and
    aux), each period recomputed in the backward pass as the reference's
    ``jax.checkpoint(policy=nothing_saveable)`` does; :func:`lm_loss` on
    top of it,
  * ``prefill``       — full-sequence forward that also emits decode caches
    (attention through the flash kernel wrapper),
  * ``decode_step``   — one token against the caches (updated in place).

:func:`make_trainable` binds a model's parameters into a
:class:`~repro_torch.models.common.FlatParams` laid out in the order of
the reference's ``ravel_pytree`` of its stacked parameter tree.

Mixers: global attention, sliding-window attention (ring cache), mLSTM
and sLSTM (recurrent states, :mod:`.xlstm`).  FFNs: dense (SwiGLU/GeGLU/
GELU/ReLU²), MoE (:mod:`.moe`; its auxiliary losses are summed over the
layers by ``forward_train``) or none.  Mamba, encoder-decoder and vision
configs raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ModelConfig, Sublayer as SublayerKind
from . import attention as attn_mod
from . import moe as moe_mod
from . import xlstm as xlstm_mod
from .attention import KVCache
from .common import FlatParams, ParamTree, leaves, materialize, stack_specs
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
           "make_trainable", "apply_sublayer_full", "apply_sublayer_decode",
           "forward_train", "lm_loss", "prefill", "decode_step"]

#: the ROADMAP.md item of each mixer kind the port does not carry
_UNPORTED_MIXERS = {"mamba": "1.7c (Mamba)"}
_MIXERS = ("attn", "local", "mlstm", "slstm")
_FFNS = ("mlp", "moe", "none")

#: one layer's decode cache: a KV cache, or an mLSTM / sLSTM state
Cache = Union[KVCache, xlstm_mod.MLSTMState, xlstm_mod.SLSTMState]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP.md item) unless
    ``cfg`` is a decoder the port carries."""
    for mixer, ffn in cfg.period:
        if mixer in _UNPORTED_MIXERS:
            raise NotImplementedError(
                f"{mixer} mixers are not ported yet: ROADMAP.md item "
                f"{_UNPORTED_MIXERS[mixer]}")
        if mixer not in _MIXERS or ffn not in _FFNS:
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
def _mixer_spec(cfg: ModelConfig, mixer: str) -> Dict:
    if mixer == "mlstm":
        return xlstm_mod.mlstm_spec(cfg)
    if mixer == "slstm":
        return xlstm_mod.slstm_spec(cfg)
    return attn_mod.attn_spec(cfg)


def sublayer_spec(cfg: ModelConfig, sub: SublayerKind) -> Dict:
    mixer, ffn = sub
    s: Dict = {
        "norm1": rmsnorm_spec(cfg.d_model),
        "mixer": _mixer_spec(cfg, mixer),
    }
    if ffn == "mlp":
        s["norm2"] = rmsnorm_spec(cfg.d_model)
        s["ffn"] = mlp_spec(cfg)
    elif ffn == "moe":
        s["norm2"] = rmsnorm_spec(cfg.d_model)
        s["ffn"] = moe_mod.moe_spec(cfg)
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
    """One (mixer, ffn) layer: ``norm1``, ``mixer`` (attention's wq, wk,
    wv, wo and the optional q/k norms, or an mLSTM / sLSTM block's
    weights), and for mlp and moe layers ``norm2`` and ``ffn``."""

    def __init__(self, kind: SublayerKind, tree: Dict):
        super().__init__(tree)
        self.kind = tuple(kind)


class DecoderLM(nn.Module):
    """The parameters of a decoder: ``embed``, ``layers`` (one
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


def _param_at(tree, path: Sequence[str]) -> nn.Parameter:
    for k in path:
        tree = tree[k]
    return tree


def make_trainable(params: DecoderLM) -> FlatParams:
    """Bind every parameter of ``params`` into one flat buffer laid out as
    the reference's ``ravel_pytree`` of its parameter tree: the leaves in
    sorted-key order (``embed``, ``final_norm``, ``rest``, ``stack``), a
    stacked leaf being the same parameter of every period, period by
    period.  The parameters become trainable views (see
    :class:`~repro_torch.models.common.FlatParams`); the result is kept as
    ``params.flat``, and a second call returns it while its parameters
    are still bound to it; a copy (``copy.deepcopy``, ``Module.to``) of a
    trainable model gets a new flat buffer holding its current values."""
    flat = getattr(params, "flat", None)
    if flat is not None and flat.bound():
        return flat
    cfg = params.cfg
    L, n_stacked = len(cfg.period), cfg.n_periods * len(cfg.period)
    segments = []
    for path, spec in leaves(model_spec(cfg)):
        head, rest = path[0], path[1:]
        if head == "embed":
            parts = [_param_at(params.embed, rest)]
        elif head == "final_norm":
            parts = [_param_at(params.final_norm, rest)]
        elif head == "stack":
            i = int(rest[0])
            parts = [_param_at(params.layers[p * L + i], rest[1:])
                     for p in range(cfg.n_periods)]
        else:  # "rest"
            parts = [_param_at(params.layers[n_stacked + int(rest[0])],
                               rest[1:])]
        segments.append((path, spec.shape, parts))
    params.flat = FlatParams(segments)
    return params.flat


def _sublayer_cache(cfg: ModelConfig, mixer: str, batch: int, max_len: int,
                    dtype, device) -> Cache:
    if mixer == "mlstm":
        return xlstm_mod.init_mlstm_state(cfg, batch, device)
    if mixer == "slstm":
        return xlstm_mod.init_slstm_state(cfg, batch, device)
    return attn_mod.init_cache(cfg, batch, max_len,
                               cfg.window if mixer == "local" else None,
                               dtype, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device=None) -> List[Cache]:
    """One empty decode cache per layer on ``device`` (None: the card): a
    KV cache for attention (a ring buffer for local layers), a float32
    mLSTM or sLSTM state for the recurrent mixers."""
    device = resolve_device(device)
    return [_sublayer_cache(cfg, mixer, batch, max_len, dtype, device)
            for mixer, _ in layer_kinds(cfg)]


# --------------------------------------------------------------------- #
# Sublayer application
# --------------------------------------------------------------------- #
def _apply_ffn(cfg, params, sub, x, aux: Optional[Dict], decode=False):
    """The FFN sublayer.  MoE layers add their auxiliary losses to
    ``aux`` (None: not computed) and decode dropless, as the reference
    does.  ``cfg.moe.a2a`` needs a device mesh (ROADMAP.md item 1.6);
    without one the reference runs ``moe_ffn`` too."""
    ffn = sub[1]
    if ffn == "none":
        return x, aux
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        out, a = moe_mod.moe_ffn(cfg, params["ffn"], h, dropless=decode,
                                 losses=aux is not None)
        if aux is not None:
            aux = {k: aux[k] + a[k] for k in aux}
    else:
        out = mlp(params["ffn"], h, cfg.ffn_act)
    return x + out, aux


def apply_sublayer_full(
    cfg: ModelConfig, params, sub: SublayerKind, x: torch.Tensor,
    positions: torch.Tensor, *, causal: bool = True,
    collect_cache: bool = False, max_len: int = 0, cache_dtype=None,
    aux: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict], Optional[Cache]]:
    """Full-sequence sublayer (training and prefill): ``(x, aux, cache)``.
    The K/V an attention layer projects also fill its decode cache, and a
    recurrent mixer's projections also give its final state, so each is
    computed once (the reference computes them a second time for the
    cache, with the same result)."""
    mixer, _ = sub
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    new_cache = None
    if mixer == "mlstm":
        if collect_cache:
            out, new_cache = xlstm_mod.mlstm_block_with_state(
                cfg, params["mixer"], h)
        else:
            out = xlstm_mod.mlstm_block(cfg, params["mixer"], h)
    elif mixer == "slstm":
        if collect_cache:
            out, new_cache = xlstm_mod.slstm_block_with_state(
                cfg, params["mixer"], h)
        else:
            out = xlstm_mod.slstm_block(cfg, params["mixer"], h)
    else:
        window = cfg.window if mixer == "local" else None
        q, k, v = attn_mod.project_qkv(cfg, params["mixer"], h, positions)
        out = attn_mod.attend(cfg, params["mixer"], q, k, v, causal=causal,
                              window=window)
        if collect_cache:
            new_cache = _prefill_kv_cache(cfg, k, v, window, max_len,
                                          cache_dtype)
    x = x + out
    x, aux = _apply_ffn(cfg, params, sub, x, aux)
    return x, aux, new_cache


def apply_sublayer_decode(
    cfg: ModelConfig, params, sub: SublayerKind, x: torch.Tensor,
    cache: Cache, pos: int,
) -> Tuple[torch.Tensor, Cache]:
    """One-token sublayer against its cache: a KV cache is updated in
    place, a recurrent state is replaced."""
    mixer, _ = sub
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if mixer == "mlstm":
        out, new_cache = xlstm_mod.mlstm_decode(cfg, params["mixer"], h, cache)
    elif mixer == "slstm":
        out, new_cache = xlstm_mod.slstm_decode(cfg, params["mixer"], h, cache)
    else:
        window = cfg.window if mixer == "local" else None
        out, new_cache = attn_mod.decode_attention(
            cfg, params["mixer"], h, cache, pos, window=window)
    x = x + out
    x, _ = _apply_ffn(cfg, params, sub, x, None, decode=True)
    return x, new_cache


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
        x, _, c = apply_sublayer_full(
            cfg, layer, layer.kind, x, positions, causal=causal,
            collect_cache=collect_cache, max_len=max_len,
            cache_dtype=cache_dtype)
        caches.append(c)
    return x, (caches if collect_cache else None)


#: the reference's auxiliary losses (MoE only; zero for other decoders)
ZERO_AUX = ("moe_load_balance", "moe_router_z")


def _period(cfg, layers, positions, x, *aux):
    """``layers`` in order; ``aux`` (and the result after x) are the
    running ``ZERO_AUX`` sums, as tensors so that a checkpoint carries
    them."""
    aux = dict(zip(ZERO_AUX, aux))
    for layer in layers:
        x, aux, _ = apply_sublayer_full(cfg, layer, layer.kind, x, positions,
                                        aux=aux)
    return (x, *aux.values())


def forward_train(cfg: ModelConfig, params: DecoderLM,
                  batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Teacher-forced logits over the full sequence (float32) and the
    auxiliary losses (each MoE layer's, summed in layer order).  With
    autograd recording, each period runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass, as the reference's
    ``jax.checkpoint(policy=nothing_saveable)`` over its scanned periods
    does; the unstacked remainder is not recomputed, as there."""
    x, positions = _input_embed(cfg, params, batch)
    aux = tuple(x.new_zeros((), dtype=torch.float32) for _ in ZERO_AUX)
    L = len(cfg.period)
    recompute = torch.is_grad_enabled()
    for p in range(cfg.n_periods):
        fn = functools.partial(_period, cfg, params.layers[p * L:(p + 1) * L],
                               positions)
        x, *aux = (checkpoint(fn, x, *aux, use_reentrant=False) if recompute
                   else fn(x, *aux))
    x, *aux = _period(cfg, params.layers[cfg.n_periods * L:], positions, x,
                      *aux)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return (compute_logits(params.embed, cfg, x).float(),
            dict(zip(ZERO_AUX, aux)))


def lm_loss(cfg: ModelConfig, params: DecoderLM,
            batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy (mean over ``B x (S-1)``) plus the
    auxiliary losses; returns ``(total, aux)`` with ``aux["ce_loss"]``."""
    logits, aux = forward_train(cfg, params, batch)
    tgt = batch["tokens"][:, 1:].long()
    ll = torch.log_softmax(logits[:, :-1], dim=-1)
    loss = -torch.gather(ll, -1, tgt[..., None])[..., 0].mean()
    total = loss + sum(aux.values())
    return total, dict(aux, ce_loss=loss)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: DecoderLM, batch: Dict, max_len: int,
            cache_dtype=None):
    """Full forward emitting the last position's logits (B, 1, vocab) and
    one decode cache per layer (:func:`init_caches`' kinds)."""
    x, positions = _input_embed(cfg, params, batch)
    x, caches = _run_stack(
        cfg, params, x, positions, causal=True, collect_cache=True,
        max_len=max_len, cache_dtype=cache_dtype or x.dtype)
    x = rmsnorm(params.final_norm, x[:, -1:, :], cfg.norm_eps)
    return compute_logits(params.embed, cfg, x), caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: DecoderLM, caches: List[Cache],
                tokens: torch.Tensor, pos: int):
    """One-token step.  tokens: (B, 1); pos: the current index.  Returns
    the logits and the caches: KV caches updated in place, recurrent
    states replaced."""
    x = embed(params.embed, cfg, tokens)
    new_caches = []
    for layer, cache in zip(params.layers, caches):
        x, c = apply_sublayer_decode(cfg, layer, layer.kind, x, cache, pos)
        new_caches.append(c)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return compute_logits(params.embed, cfg, x), new_caches
