"""The decoder and encoder-decoder stack: its training pass and its
serving passes.

Counterpart of ``repro.models.transformer``.  The reference scans a
repeating *period* of (mixer, ffn) sublayers over stacked parameters, plus
an unscanned remainder; the scan, remat and the loop barrier exist for
XLA.  Here the stack is a :class:`DecoderLM` holding one :class:`Sublayer`
module per layer, in order (period 0's sublayers, period 1's, ..., then
the remainder), each with the reference's parameter shapes and keys, and
the passes are a Python loop over them.

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

Mixers: global attention, sliding-window attention (ring cache), Mamba
(a (conv, ssm) state, :mod:`.mamba`; its prefill scan through the
``selective_scan`` kernel on the card), mLSTM and sLSTM (recurrent
states, :mod:`.xlstm`).  FFNs: dense (SwiGLU/GeGLU/GELU/ReLU²), MoE
(:mod:`.moe`; its auxiliary losses are summed over the layers by
``forward_train``) or none.

Whisper (``kind="encdec"``) adds a bidirectional :class:`Encoder` over
precomputed frame embeddings and cross-attention in every decoder layer
(``norm_x``, ``cross``); each decoder layer's decode cache is then a
:class:`CrossCache`, its self-attention cache beside the cross K/V the
prefill projects once from the encoder output.  Positions are sinusoidal
(float64 tables in the prefill and the encoder, float32 in decode, as the
reference computes them).  Qwen2-VL merges precomputed vision patch
embeddings into the token stream (``vision_embeds``) and takes M-RoPE
position ids (``positions`` (B, 3, S); ``mrope_positions`` (B, 3, 1) in
decode).

Tensor parallelism along ``"model"``: :func:`shard_params` cuts a whole
model into a rank's slices (the rules' ``"model"`` placements of
:func:`model_spec`: heads, KV heads, FFN columns, the vocabulary, the
routed experts and their router columns, and the Mamba and xLSTM
``inner`` channels split where the ``"model"`` size divides them; the
norms whole), and under ``models.common.use_mesh`` the layers split their
products over the ranks (see :mod:`.attention`, :mod:`.layers`,
:mod:`.moe`, :mod:`.mamba`, :mod:`.xlstm`).  Logits are then this rank's
vocabulary columns: :func:`lm_loss` takes a vocab-parallel cross-entropy
and :func:`gather_logits` gathers whole ones for greedy decoding.  Every
cache holds what the reference's cache rule gives the rank
(:func:`cache_shardings`): KV caches split along the sequence over the
rules' cache axes (``attention.SeqKVCache``), recurrent states along
their ``inner`` dimension; :func:`init_caches` takes the mesh and rules.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ModelConfig, Sublayer as SublayerKind
from ..distributed import collectives as coll
from . import attention as attn_mod
from . import layers as layers_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import xlstm as xlstm_mod
from .attention import KVCache
from .common import (FlatParams, ParamTree, current_mesh, leaves,
                     materialize, stack_specs, tree_map, use_mesh)
from .layers import (
    embed,
    embed_spec,
    logits as compute_logits,
    mlp,
    mlp_spec,
    rmsnorm,
    rmsnorm_spec,
    sinusoidal_positions,
    vocab_axis,
)

__all__ = ["check_ported", "sublayer_spec", "model_spec", "Sublayer",
           "Encoder", "DecoderLM", "CrossCache", "layer_kinds",
           "init_params", "abstract_params", "shard_params", "init_caches",
           "abstract_caches", "cache_shardings", "shard_caches",
           "make_trainable",
           "apply_sublayer_full", "apply_sublayer_decode", "forward_train",
           "lm_loss", "gather_logits", "prefill", "decode_step",
           "clear_host_tables"]

_MIXERS = ("attn", "local", "mamba", "mlstm", "slstm")
_FFNS = ("mlp", "moe", "none")
#: the encoder's one sublayer kind
ENC_SUBLAYER: SublayerKind = ("attn", "mlp")


class CrossCache(NamedTuple):
    """An encoder-decoder layer's decode cache: ``kv``, its self-attention
    KV cache, and ``cross``, the K/V of its cross-attention projected from
    the encoder output, (B, Se, nkv, hd), written by the prefill."""

    kv: KVCache
    cross: KVCache


#: one layer's decode cache: a KV cache (with the cross K/V for an
#: encoder-decoder), or a Mamba, mLSTM or sLSTM state
Cache = Union[KVCache, CrossCache, mamba_mod.MambaState,
              xlstm_mod.MLSTMState, xlstm_mod.SLSTMState]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless every sublayer of ``cfg`` is a kind the
    port carries."""
    for mixer, ffn in cfg.period:
        if mixer not in _MIXERS or ffn not in _FFNS:
            raise ValueError(f"unknown sublayer {(mixer, ffn)}")


# --------------------------------------------------------------------- #
# Parameter specs
# --------------------------------------------------------------------- #
def _mixer_spec(cfg: ModelConfig, mixer: str) -> Dict:
    if mixer == "mamba":
        return mamba_mod.mamba_spec(cfg)
    if mixer == "mlstm":
        return xlstm_mod.mlstm_spec(cfg)
    if mixer == "slstm":
        return xlstm_mod.slstm_spec(cfg)
    return attn_mod.attn_spec(cfg)


def sublayer_spec(cfg: ModelConfig, sub: SublayerKind,
                  cross: bool = False) -> Dict:
    """One layer's parameter specs."""
    mixer, ffn = sub
    s: Dict = {
        "norm1": rmsnorm_spec(cfg.d_model),
        "mixer": _mixer_spec(cfg, mixer),
    }
    if cross:
        s["norm_x"] = rmsnorm_spec(cfg.d_model)
        s["cross"] = attn_mod.cross_attn_spec(cfg)
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
    under ``rest``; an encoder-decoder's decoder layers also hold
    ``norm_x`` and ``cross``, and ``encoder`` holds its (attn, mlp) layer
    stacked over ``n_enc_layers`` and its ``final_norm``."""
    check_ported(cfg)
    cross = cfg.kind == "encdec"
    s: Dict = {"embed": embed_spec(cfg), "final_norm": rmsnorm_spec(cfg.d_model)}
    if cfg.n_periods > 0:
        s["stack"] = stack_specs(
            {str(i): sublayer_spec(cfg, sub, cross)
             for i, sub in enumerate(cfg.period)}, cfg.n_periods)
    s["rest"] = {
        str(i): sublayer_spec(cfg, sub, cross)
        for i, sub in enumerate(cfg.remainder)
    }
    if cross:
        s["encoder"] = {
            "stack": stack_specs({"0": sublayer_spec(cfg, ENC_SUBLAYER)},
                                 cfg.n_enc_layers),
            "final_norm": rmsnorm_spec(cfg.d_model),
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


class Encoder(nn.Module):
    """An encoder-decoder's encoder: ``layers`` (one (attn, mlp)
    :class:`Sublayer` per layer, in order) and ``final_norm``."""

    def __init__(self, layer_trees: Sequence[Dict], final_norm_tree: Dict):
        super().__init__()
        self.layers = nn.ModuleList(Sublayer(ENC_SUBLAYER, t)
                                    for t in layer_trees)
        self.final_norm = ParamTree(final_norm_tree)


class DecoderLM(nn.Module):
    """The parameters of a decoder: ``embed``, ``layers`` (one
    :class:`Sublayer` per layer, in order) and ``final_norm``; for an
    encoder-decoder also ``encoder`` (an :class:`Encoder` built from
    ``encoder = (layer_trees, final_norm_tree)``; None otherwise)."""

    def __init__(self, cfg: ModelConfig, embed_tree: Dict,
                 layer_trees: Sequence[Dict], final_norm_tree: Dict,
                 encoder: Optional[Tuple[Sequence[Dict], Dict]] = None):
        super().__init__()
        check_ported(cfg)
        kinds = layer_kinds(cfg)
        if len(layer_trees) != len(kinds):
            raise ValueError(f"{cfg.name}: expected {len(kinds)} layers, "
                             f"got {len(layer_trees)}")
        if (encoder is not None) != (cfg.kind == "encdec"):
            raise ValueError(f"{cfg.name} (kind {cfg.kind}): an encoder is "
                             f"{'required' if encoder is None else 'unused'}")
        if encoder is not None and len(encoder[0]) != cfg.n_enc_layers:
            raise ValueError(f"{cfg.name}: expected {cfg.n_enc_layers} "
                             f"encoder layers, got {len(encoder[0])}")
        self.cfg = cfg
        self.embed = ParamTree(embed_tree)
        self.layers = nn.ModuleList(
            Sublayer(kind, t) for kind, t in zip(kinds, layer_trees))
        self.final_norm = ParamTree(final_norm_tree)
        self.encoder = None if encoder is None else Encoder(*encoder)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                dtype=None, device=None, mesh=None, rules=None) -> DecoderLM:
    """Random parameters from ``generator`` (seed 0 on ``device`` when
    None), drawn layer by layer on ``device`` (None: the card) in the
    reference's top-level order: the embedding first, then (an
    encoder-decoder's) each encoder layer and the encoder's final norm,
    then each decoder layer, then the final norm.  With ``mesh`` (a rank
    of a mesh) the rank's slices, as :func:`shard_params` cuts them under
    ``rules``, of the same draws: each leaf is cut as it is drawn, so a
    model too large for the device whole can be built."""
    check_ported(cfg)
    device = resolve_device(device)
    dt = dtype or getattr(torch, cfg.param_dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=generator, device=device, dtype=dt)

    def mk(spec):
        shard = None if mesh is None else _tp_shardings(spec, mesh, rules)
        return materialize(spec, shardings=shard, **kw)

    cross = cfg.kind == "encdec"
    emb = mk(embed_spec(cfg))
    encoder = None
    if cross:
        encoder = ([mk(sublayer_spec(cfg, ENC_SUBLAYER))
                    for _ in range(cfg.n_enc_layers)],
                   mk(rmsnorm_spec(cfg.d_model)))
    layers = [mk(sublayer_spec(cfg, sub, cross)) for sub in layer_kinds(cfg)]
    final = mk(rmsnorm_spec(cfg.d_model))
    return DecoderLM(cfg, emb, layers, final, encoder)


def _tp_shardings(spec, mesh, rules=None):
    """The ``"model"`` placements of a spec tree under ``rules`` (default
    the baseline's)."""
    from ..distributed.sharding import (BASE_RULES, model_rules,
                                        spec_tree_to_shardings)

    return spec_tree_to_shardings(
        spec, model_rules(BASE_RULES if rules is None else rules), mesh)


def abstract_params(cfg: ModelConfig, dtype=None, mesh=None,
                    rules=None) -> DecoderLM:
    """:func:`init_params`' model on the meta device: every parameter's
    shape and dtype (``cfg.param_dtype`` unless ``dtype``), no storage
    (the dry run's parameters; the reference's ``abstract_params``);
    with ``mesh``, the rank's slices (:func:`shard_params`)."""
    if mesh is not None:
        return shard_params(abstract_params(cfg, dtype), mesh, rules)
    check_ported(cfg)
    dt = dtype or getattr(torch, cfg.param_dtype)

    def mk(tree):
        return tree_map(lambda s: torch.empty(s.shape, dtype=dt,
                                              device="meta"), tree)

    cross = cfg.kind == "encdec"
    encoder = None
    if cross:
        encoder = ([mk(sublayer_spec(cfg, ENC_SUBLAYER))
                    for _ in range(cfg.n_enc_layers)],
                   mk(rmsnorm_spec(cfg.d_model)))
    return DecoderLM(cfg, mk(embed_spec(cfg)),
                     [mk(sublayer_spec(cfg, sub, cross))
                      for sub in layer_kinds(cfg)],
                     mk(rmsnorm_spec(cfg.d_model)), encoder)


def _tree_of(module: ParamTree) -> Dict:
    return {k: (_tree_of(module[k]) if isinstance(module[k], ParamTree)
                else module[k].detach()) for k in module.keys()}


def shard_params(params: DecoderLM, mesh, rules=None) -> DecoderLM:
    """This rank's tensor-parallel slices of a whole model: every
    parameter cut along ``"model"`` as the ``"model"`` part of ``rules``
    (default the baseline's) places :func:`model_spec`'s leaves
    (``distributed.sharding.model_slice``), copied, so the whole model
    can be freed.  Leaves stay whole along the data axes."""
    from ..distributed.sharding import model_slice

    cfg = params.cfg
    cross = cfg.kind == "encdec"

    def cut(module, spec):
        shard = _tp_shardings(spec, mesh, rules)
        return tree_map(lambda t: t.clone(memory_format=torch.contiguous_format),
                        model_slice(_tree_of(module), shard))

    encoder = None
    if params.encoder is not None:
        encoder = ([cut(layer, sublayer_spec(cfg, ENC_SUBLAYER))
                    for layer in params.encoder.layers],
                   cut(params.encoder.final_norm, rmsnorm_spec(cfg.d_model)))
    return DecoderLM(
        cfg, cut(params.embed, embed_spec(cfg)),
        [cut(layer, sublayer_spec(cfg, layer.kind, cross))
         for layer in params.layers],
        cut(params.final_norm, rmsnorm_spec(cfg.d_model)), encoder)


def _param_at(tree, path: Sequence[str]) -> nn.Parameter:
    for k in path:
        tree = tree[k]
    return tree


def make_trainable(params: DecoderLM,
                   dtype: torch.dtype = torch.float32) -> FlatParams:
    """Bind every parameter of ``params`` into one flat buffer laid out as
    the reference's ``ravel_pytree`` of its parameter tree: the leaves in
    sorted-key order (``embed``, ``encoder`` where there is one,
    ``final_norm``, ``rest``, ``stack``), a stacked leaf being the same
    parameter of every period (every encoder layer), period by period;
    a rank's slices (:func:`shard_params`) in their local shapes, each
    :class:`~repro_torch.models.common.FlatLeaf` saying whether it is
    whole.  The parameters become trainable views (see
    :class:`~repro_torch.models.common.FlatParams`); the result is kept as
    ``params.flat``, and a second call returns it while its parameters
    are still bound to it; a copy (``copy.deepcopy``, ``Module.to``) of a
    trainable model gets a new flat buffer holding its current values.
    ``dtype``: the buffers' (float32, the port's training dtype)."""
    flat = getattr(params, "flat", None)
    if flat is not None and flat.bound() and flat.theta.dtype == dtype:
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
        elif head == "encoder" and rest[0] == "final_norm":
            parts = [_param_at(params.encoder.final_norm, rest[1:])]
        elif head == "encoder":  # ("stack", "0", ...)
            parts = [_param_at(layer, rest[2:])
                     for layer in params.encoder.layers]
        elif head == "stack":
            i = int(rest[0])
            parts = [_param_at(params.layers[p * L + i], rest[1:])
                     for p in range(cfg.n_periods)]
        else:  # "rest"
            parts = [_param_at(params.layers[n_stacked + int(rest[0])],
                               rest[1:])]
        # a rank's slice of a leaf has its local shape
        shape = tuple(parts[0].shape)
        if len(spec.shape) > len(shape):  # stacked over periods / layers
            shape = (len(parts),) + shape
        segments.append((path, shape, parts, shape == tuple(spec.shape)))
    params.flat = FlatParams(segments, dtype)
    return params.flat


def _sublayer_cache(cfg: ModelConfig, mixer: str, batch: int, max_len: int,
                    dtype, device) -> Cache:
    if mixer == "mamba":
        return mamba_mod.init_mamba_state(cfg, batch, dtype, device)
    if mixer == "mlstm":
        return xlstm_mod.init_mlstm_state(cfg, batch, device)
    if mixer == "slstm":
        return xlstm_mod.init_slstm_state(cfg, batch, device)
    return attn_mod.init_cache(cfg, batch, max_len,
                               cfg.window if mixer == "local" else None,
                               dtype, device)


def _whole_caches(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
                  enc_len: int) -> List[Cache]:
    caches = [_sublayer_cache(cfg, mixer, batch, max_len, dtype, device)
              for mixer, _ in layer_kinds(cfg)]
    if cfg.kind == "encdec":
        caches = [CrossCache(c, attn_mod.init_cache(cfg, batch, enc_len, None,
                                                    dtype, device))
                  for c in caches]
    return caches


def _cache_leaf_axes(cache, cross: bool = False):
    """The reference's logical axes of each tensor of one layer's cache
    (``launch.inputs.cache_axes`` of an unstacked layer)."""
    if isinstance(cache, CrossCache):
        return CrossCache(_cache_leaf_axes(cache.kv),
                          _cache_leaf_axes(cache.cross, cross=True))
    if isinstance(cache, KVCache):
        kv = ("batch", "enc_seq" if cross else "cache_seq", "kv_heads", None)
        return KVCache(kv, kv)
    return type(cache)(*(("batch",) + ("inner",) * (t.ndim - 1)
                         for t in cache))


def cache_shardings(cfg: ModelConfig, caches, mesh, rules=None,
                    batch: Optional[int] = None):
    """The placements (``distributed.sharding.Sharding``) of every tensor
    of whole caches (:func:`init_caches`' on one rank, any device) on
    ``mesh`` under ``rules`` (default the baseline's): the reference's
    cache rule, ``resolve_axes`` of ``("batch", "cache_seq", "kv_heads",
    None)`` for a KV cache, ``enc_seq`` for the cross K/V, ``("batch",
    "inner", ...)`` for a recurrent state, except that the batch is split
    over the batch rule's mesh axes where they divide ``batch`` (default
    the caches' batch) and else whole, as the step builders split it."""
    from ..distributed.sharding import BASE_RULES, Sharding, resolve_axes

    rules = BASE_RULES if rules is None else rules
    rule = rules.get("batch") or ()
    rule = rule if isinstance(rule, tuple) else (rule,)
    data = tuple(a for a in mesh.axes if a in rule)
    dp = 1
    for a in data:
        dp *= mesh.shape[a]

    def one(t, axes):
        B = batch if batch is not None else t.shape[0]
        spec = list(resolve_axes(axes, (B,) + tuple(t.shape[1:]), rules,
                                 mesh))
        spec[0] = ((data if len(data) > 1 else data[0])
                   if data and B % dp == 0 else None)
        return Sharding(mesh, tuple(spec))

    def walk(c, axes):
        if isinstance(c, torch.Tensor):
            return one(c, axes)
        return type(c)(*(walk(t, a) for t, a in zip(c, axes)))

    return [walk(c, _cache_leaf_axes(c)) for c in caches]


def _placed(c, whole, shard, device, fill: bool = True):
    """A rank's cache from the slices ``c`` of ``whole``: empty ones of
    their shapes on ``device`` (zeros; an mLSTM or sLSTM stabiliser
    -1e30), or, without ``fill``, copies of them; a KV cache split along
    its sequence as a :class:`~.attention.SeqKVCache`."""
    if isinstance(c, CrossCache):
        return CrossCache(_placed(c.kv, whole.kv, shard.kv, device, fill),
                          _placed(c.cross, whole.cross, shard.cross, device,
                                  fill))
    out = [torch.full(t.shape, -1e30 if f == "m" else 0, dtype=t.dtype,
                      device=device) if fill else t.clone(
                          memory_format=torch.contiguous_format)
           for f, t in zip(c._fields, c)]
    axes = shard.k.spec[1] if isinstance(c, KVCache) else None
    if axes is None:
        return type(c)(*out)
    return attn_mod.SeqKVCache(*out, attn_mod.SeqSplit(
        axes if isinstance(axes, tuple) else (axes,), whole.k.shape[1]))


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device=None, mesh=None, rules=None,
                enc_len: int = 1) -> List[Cache]:
    """One empty decode cache per layer on ``device`` (None: the card): a
    KV cache for attention (a ring buffer for local layers), a Mamba
    state (its conv window in ``dtype``, its ssm state float32), a
    float32 mLSTM or sLSTM state.  An encoder-decoder's layers get a
    :class:`CrossCache` whose cross K/V hold ``enc_len`` zero positions
    (one, the reference's placeholder: the encoder's length is known at
    prefill, which writes its K/V).  With ``mesh`` (a rank of a mesh),
    ``batch`` is the global batch and the caches are the rank's pieces
    under ``rules`` (:func:`cache_shardings`)."""
    device = torch.device("meta") if torch.device(
        device or "cuda").type == "meta" else resolve_device(device)
    if mesh is None:
        return _whole_caches(cfg, batch, max_len, dtype, device, enc_len)
    return _rank_caches(cfg, batch, max_len, dtype, device, mesh, rules,
                        enc_len)


def shard_caches(cfg: ModelConfig, caches: List[Cache], mesh, rules=None,
                 batch: Optional[int] = None) -> List[Cache]:
    """This rank's copy of whole caches (one rank's, filled) under
    ``rules`` (:func:`cache_shardings`; ``batch`` the global batch,
    default the caches'): what :func:`init_caches` with ``mesh`` makes,
    holding their values."""
    from ..distributed.sharding import local_tree

    shard = cache_shardings(cfg, caches, mesh, rules, batch)
    return [_placed(c, w, s, None, fill=False)
            for c, w, s in zip(local_tree(caches, shard), caches, shard)]


def _rank_caches(cfg, batch, max_len, dtype, device, mesh, rules, enc_len):
    from ..distributed.sharding import local_tree

    whole = _whole_caches(cfg, batch, max_len, dtype, torch.device("meta"),
                          enc_len)
    shard = cache_shardings(cfg, whole, mesh, rules)
    return [_placed(c, w, s, device)
            for c, w, s in zip(local_tree(whole, shard), whole, shard)]


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    enc_len: int = 1, mesh=None, rules=None) -> List[Cache]:
    """:func:`init_caches`' caches on the meta device (no storage); an
    encoder-decoder's cross K/V hold ``enc_len`` positions."""
    return init_caches(cfg, batch, max_len, dtype, torch.device("meta"),
                       mesh, rules, enc_len)


# --------------------------------------------------------------------- #
# Sublayer application
# --------------------------------------------------------------------- #
def _apply_ffn(cfg, params, sub, x, aux: Optional[Dict], decode=False):
    """The FFN sublayer.  MoE layers add their auxiliary losses to
    ``aux`` (None: not computed) and decode dropless, as the reference
    does.  With ``cfg.moe.a2a`` under a mesh with a ``"model"`` axis
    (:func:`~repro_torch.models.common.use_mesh`) a MoE layer outside
    decode takes the expert-parallel all-to-all
    (:mod:`~repro_torch.models.moe_shard_map`); without one the reference
    runs ``moe_ffn`` too."""
    ffn = sub[1]
    if ffn == "none":
        return x, aux
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        mesh = current_mesh()
        if (cfg.moe.a2a and mesh is not None and "model" in mesh.shape
                and not decode):
            from .moe_shard_map import moe_ffn_a2a

            data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
            out, a = moe_ffn_a2a(cfg, params["ffn"], h, mesh,
                                 data_axes=data_axes)
        else:
            out, a = moe_mod.moe_ffn(cfg, params["ffn"], h, dropless=decode,
                                     losses=aux is not None)
        if aux is not None:
            aux = {k: aux[k] + a[k] for k in aux}
    else:
        out = mlp(params["ffn"], h, cfg.ffn_act, d_ff=cfg.d_ff)
    return x + out, aux


def apply_sublayer_full(
    cfg: ModelConfig, params, sub: SublayerKind, x: torch.Tensor,
    positions: torch.Tensor, *, causal: bool = True,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    collect_cache: bool = False, max_len: int = 0, cache_dtype=None,
    aux: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict], Optional[Cache]]:
    """Full-sequence sublayer (training, prefill and the encoder):
    ``(x, aux, cache)``.  The K/V an attention layer projects also fill its
    decode cache, and a recurrent mixer's projections also give its final
    state, so each is computed once (the reference computes them a second
    time for the cache, with the same result).  With ``cross_kv`` (the
    context, the encoder output twice) the layer cross-attends after its
    mixer, and its cache is a :class:`CrossCache` holding the cross K/V
    that attention used (the same products as the reference's
    ``_precompute_cross_kv_all``)."""
    mixer, _ = sub
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    new_cache = None
    if mixer == "mamba":
        if collect_cache:
            out, new_cache = mamba_mod.mamba_block_with_state(
                cfg, params["mixer"], h)
        else:
            out = mamba_mod.mamba_block(cfg, params["mixer"], h)
    elif mixer == "mlstm":
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
            new_cache = attn_mod.prefill_cache(cfg, params["mixer"], h,
                                               positions, k, v, window,
                                               max_len, cache_dtype)
    x = x + out
    if cross_kv is not None:
        hx = rmsnorm(params["norm_x"], x, cfg.norm_eps)
        ck, cv = attn_mod.project_cross_kv(cfg, params["cross"], *cross_kv)
        x = x + attn_mod.cross_attention(cfg, params["cross"], hx, ck, cv)
        if collect_cache:
            new_cache = CrossCache(new_cache, attn_mod.prefill_cache(
                cfg, params["cross"], cross_kv[0], None, ck, cv, None,
                ck.shape[1], name="enc_seq"))
    x, aux = _apply_ffn(cfg, params, sub, x, aux)
    return x, aux, new_cache


def apply_sublayer_decode(
    cfg: ModelConfig, params, sub: SublayerKind, x: torch.Tensor,
    cache: Cache, pos: int, mrope_positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Cache]:
    """One-token sublayer against its cache: a KV cache is updated in
    place, a recurrent state is replaced; a :class:`CrossCache`'s cross
    K/V are read.  ``mrope_positions`` (B, 3, 1) rotate an M-RoPE
    config's q and k."""
    mixer, _ = sub
    cross = cache.cross if isinstance(cache, CrossCache) else None
    if cross is not None:
        cache = cache.kv
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if mixer == "mamba":
        out, new_cache = mamba_mod.mamba_decode(cfg, params["mixer"], h, cache)
    elif mixer == "mlstm":
        out, new_cache = xlstm_mod.mlstm_decode(cfg, params["mixer"], h, cache)
    elif mixer == "slstm":
        out, new_cache = xlstm_mod.slstm_decode(cfg, params["mixer"], h, cache)
    else:
        window = cfg.window if mixer == "local" else None
        out, new_cache = attn_mod.decode_attention(
            cfg, params["mixer"], h, cache, pos, window=window,
            positions=mrope_positions)
    x = x + out
    if cross is not None:
        hx = rmsnorm(params["norm_x"], x, cfg.norm_eps)
        x = x + attn_mod.decode_cross_attention(cfg, params["cross"], hx,
                                                cross.k, cross.v, cross)
        new_cache = CrossCache(new_cache, cross)
    x, _ = _apply_ffn(cfg, params, sub, x, None, decode=True)
    return x, new_cache


# --------------------------------------------------------------------- #
# Full model passes
# --------------------------------------------------------------------- #
def clear_host_tables() -> None:
    """Empty the caches of host-made tables (RoPE frequencies, M-RoPE
    sections, sinusoids), so that the next step makes them again, as a
    fresh process's first step does (the dry run counts their making in
    every trace)."""
    for fn in (layers_mod._rope_freqs_on, layers_mod._section_ids,
               _sinusoid_on, _sinusoid_denom_on):
        fn.cache_clear()


@functools.lru_cache(maxsize=8)
def _sinusoid_on(S: int, d: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """:func:`~.layers.sinusoidal_positions` (float64) cast to ``dtype``,
    made once per device for the last few lengths (a serve sees one
    frame count and a few prompt lengths)."""
    return torch.as_tensor(sinusoidal_positions(S, d), dtype=dtype,
                           device=device)


@functools.lru_cache(maxsize=None)
def _sinusoid_denom_on(d: int, device: torch.device) -> torch.Tensor:
    """``10000 ** (dim / d)`` in float32 for the even ``dim`` (decode's
    one-position table), made once per device."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    return torch.pow(10000.0, dim / d)


def _decode_sinusoid(d: int, pos: int, dtype, device) -> torch.Tensor:
    """The one-position sinusoidal embedding at ``pos``, computed in
    float32 (the prefill's table is float64), as the reference's
    ``decode_step`` computes it."""
    denom = _sinusoid_denom_on(d, device)
    ang = denom.new_full(denom.shape, float(pos)) / denom
    pe = torch.zeros(d, dtype=dtype, device=device)
    pe[0::2] = ang.sin().to(dtype)
    pe[1::2] = ang.cos().to(dtype)
    return pe


def _merge_vision(x: torch.Tensor, batch: Dict) -> torch.Tensor:
    """The first ``vision_embeds.shape[1]`` positions replaced by the
    precomputed vision patch embeddings."""
    ve = batch.get("vision_embeds")
    if ve is None:
        return x
    return torch.cat([ve.to(x.dtype), x[:, ve.shape[1]:]], dim=1)


def _input_embed(cfg: ModelConfig, params: DecoderLM,
                 batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, positions): the token embeddings with the vision block
    merged and the sinusoidal table added where the config has them; the
    batch's ``positions`` ((B, S), or (B, 3, S) for M-RoPE) or 0..S-1."""
    tokens = batch["tokens"]
    x = _merge_vision(embed(params.embed, cfg, tokens), batch)
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoid_on(S, cfg.d_model, x.dtype, x.device)[None]
    return x, positions


def _encode(cfg: ModelConfig, params: DecoderLM, batch: Dict) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings
    (``audio_embeds`` (B, Se, d), the stub frontend's): the sinusoidal
    table added, every (attn, mlp) layer non-causal, the final norm."""
    frames = batch["audio_embeds"]
    B, Se, _ = frames.shape
    x = frames + _sinusoid_on(Se, cfg.d_model, frames.dtype,
                              frames.device)[None]
    positions = torch.arange(Se, dtype=torch.int32,
                             device=frames.device)[None].expand(B, Se)
    for layer in params.encoder.layers:
        x, _, _ = apply_sublayer_full(cfg, layer, ENC_SUBLAYER, x, positions,
                                      causal=False)
    return rmsnorm(params.encoder.final_norm, x, cfg.norm_eps)


def _cross_context(cfg: ModelConfig, params: DecoderLM, batch: Dict):
    """The cross-attention context of an encoder-decoder (the encoder
    output as keys and values), None for a decoder."""
    if cfg.kind != "encdec":
        return None
    enc_out = _encode(cfg, params, batch)
    return enc_out, enc_out


def _run_stack(cfg, params: DecoderLM, x, positions, *, causal=True,
               cross_kv=None, collect_cache=False, max_len=0,
               cache_dtype=None):
    """Every layer in order.  Returns (x, caches or None)."""
    caches = []
    for layer in params.layers:
        x, _, c = apply_sublayer_full(
            cfg, layer, layer.kind, x, positions, causal=causal,
            cross_kv=cross_kv, collect_cache=collect_cache, max_len=max_len,
            cache_dtype=cache_dtype)
        caches.append(c)
    return x, (caches if collect_cache else None)


#: the reference's auxiliary losses (MoE only; zero for other decoders)
ZERO_AUX = ("moe_load_balance", "moe_router_z")


def _period(cfg, layers, positions, cross_kv, x, *aux):
    """``layers`` in order; ``aux`` (and the result after x) are the
    running ``ZERO_AUX`` sums, as tensors so that a checkpoint carries
    them."""
    aux = dict(zip(ZERO_AUX, aux))
    for layer in layers:
        x, aux, _ = apply_sublayer_full(cfg, layer, layer.kind, x, positions,
                                        cross_kv=cross_kv, aux=aux)
    return (x, *aux.values())


def _period_on(mesh, *args):
    """:func:`_period` under ``mesh``: a period recomputed in the backward
    pass (which may run outside the caller's ``use_mesh``, or on
    autograd's own thread) splits its work as its forward did."""
    with use_mesh(mesh):
        return _period(*args)


def forward_train(cfg: ModelConfig, params: DecoderLM,
                  batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Teacher-forced logits over the full sequence (float32) and the
    auxiliary losses (each MoE layer's, summed in layer order).  With
    autograd recording, each period runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass, as the reference's
    ``jax.checkpoint(policy=nothing_saveable)`` over its scanned periods
    does; the unstacked remainder and an encoder-decoder's encoder (not
    rematerialised in the reference either) are not recomputed."""
    cross_kv = _cross_context(cfg, params, batch)
    x, positions = _input_embed(cfg, params, batch)
    aux = tuple(x.new_zeros((), dtype=torch.float32) for _ in ZERO_AUX)
    L = len(cfg.period)
    recompute = torch.is_grad_enabled()
    mesh = current_mesh()
    for p in range(cfg.n_periods):
        fn = functools.partial(_period_on, mesh, cfg,
                               params.layers[p * L:(p + 1) * L], positions,
                               cross_kv)
        x, *aux = (checkpoint(fn, x, *aux, use_reentrant=False) if recompute
                   else fn(x, *aux))
    x, *aux = _period(cfg, params.layers[cfg.n_periods * L:], positions,
                      cross_kv, x, *aux)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = compute_logits(params.embed, cfg, x)  # float64 stays float64
    return (logits.to(torch.promote_types(logits.dtype, torch.float32)),
            dict(zip(ZERO_AUX, aux)))


def lm_loss(cfg: ModelConfig, params: DecoderLM,
            batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy (mean over ``B x (S-1)``) plus the
    auxiliary losses; returns ``(total, aux)`` with ``aux["ce_loss"]``."""
    logits, aux = forward_train(cfg, params, batch)
    tgt = batch["tokens"][:, 1:].long()
    ax = vocab_axis(cfg, logits.shape[-1])
    if ax is None:
        ll = torch.log_softmax(logits[:, :-1], dim=-1)
        loss = -torch.gather(ll, -1, tgt[..., None])[..., 0].mean()
    else:  # this rank's vocabulary columns
        loss = coll.vocab_cross_entropy(logits[:, :-1], tgt, ax.group,
                                        ax.index * logits.shape[-1]).mean()
    total = loss + sum(aux.values())
    return total, dict(aux, ce_loss=loss)


def gather_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Whole-vocabulary logits from this rank's columns (all-gathered
    over ``"model"``; the same tensor without a split), for greedy
    decoding."""
    ax = vocab_axis(cfg, logits.shape[-1])
    return logits if ax is None else coll.all_gather(logits, ax.group, -1)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: DecoderLM, batch: Dict, max_len: int,
            cache_dtype=None):
    """Full forward emitting the last position's logits (B, 1, vocab; a
    rank's columns under a vocabulary split) and one decode cache per
    layer (:func:`init_caches`' kinds; an
    encoder-decoder's hold the cross K/V of the encoder run on
    ``batch["audio_embeds"]``)."""
    cross_kv = _cross_context(cfg, params, batch)
    x, positions = _input_embed(cfg, params, batch)
    x, caches = _run_stack(
        cfg, params, x, positions, causal=True, cross_kv=cross_kv,
        collect_cache=True, max_len=max_len,
        cache_dtype=cache_dtype or x.dtype)
    x = rmsnorm(params.final_norm, x[:, -1:, :], cfg.norm_eps)
    return compute_logits(params.embed, cfg, x), caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: DecoderLM, caches: List[Cache],
                tokens: torch.Tensor, pos: int,
                mrope_positions: Optional[torch.Tensor] = None):
    """One-token step.  tokens: (B, 1); pos: the current index (the cache
    slot, and the sinusoidal position); ``mrope_positions`` (B, 3, 1): an
    M-RoPE config's position ids of the token.  Returns the logits and the
    caches: KV caches updated in place, recurrent states replaced."""
    x = embed(params.embed, cfg, tokens)
    if cfg.pos_embed == "sinusoidal":
        x = x + _decode_sinusoid(cfg.d_model, pos, x.dtype, x.device)
    new_caches = []
    for layer, cache in zip(params.layers, caches):
        x, c = apply_sublayer_decode(cfg, layer, layer.kind, x, cache, pos,
                                     mrope_positions)
        new_caches.append(c)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return compute_logits(params.embed, cfg, x), new_caches
