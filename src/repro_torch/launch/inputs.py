"""Per-(architecture x input-shape) cell planning for the dry run.

Counterpart of ``repro.launch.inputs``.  A *cell* = (arch config adjusted
for the shape, abstract inputs, sharding rules, step kind).  The four
assigned shapes:

  train_4k     seq 4096,    global_batch 256  -> train step
  prefill_32k  seq 32768,   global_batch 32   -> prefill
  decode_32k   seq 32768,   global_batch 128  -> decode step (KV = seq)
  long_500k    seq 524288,  global_batch 1    -> decode step, sub-quadratic
                                                 archs only

Modality stubs: Whisper gets post-conv frame embeddings at
``seq // STUB_DIV`` and ``WHISPER_DEC_LEN`` decoder tokens; Qwen2-VL gets
vision patch embeddings for the first ``seq // STUB_DIV`` positions plus
M-RoPE position ids.  The port's serving cells give Whisper a whole
padded clip instead, ``WHISPER_FRAMES`` (not in the reference).

Abstract inputs and caches are tensors on the meta device (shape and
dtype, no storage) where the reference has ``jax.ShapeDtypeStruct``s; a
cache tree has the reference's layout (``stack`` with a leading period
dimension, ``rest``, and an encoder-decoder's ``cross``), so the dry run
resolves the reference's logical axes on it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import BASE_RULES, Rules, long_decode_rules
from ..models import transformer as tf

__all__ = ["WHISPER_DEC_LEN", "WHISPER_FRAMES", "STUB_DIV", "ShapeSpec",
           "SHAPES", "cell_is_runnable", "adjusted_config", "grad_accum_for",
           "batch_specs", "cache_abstract", "cache_axes", "rules_for",
           "tree_leaves_with_path"]

#: Whisper's decoder text context (tokens)
WHISPER_DEC_LEN = 448

#: Whisper's encoder frames: every clip is padded to 30 s, 1500 frames
#: after the conv frontend
WHISPER_FRAMES = 1500

#: the encoder frames (Whisper) and the vision block (Qwen2-VL) take
#: ``seq // STUB_DIV`` positions
STUB_DIV = 4

_META = torch.device("meta")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped (DESIGN §4)"
    return True, ""


def adjusted_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Chunking knobs for long sequences (exact, memory-bounded paths)."""
    changes: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        seq = shape.seq if cfg.kind != "encdec" else shape.seq // STUB_DIV
        if seq > 4096:
            changes["attn_chunk"] = 1024
            changes["ssm_chunk"] = 1024
        elif seq > 1024:
            changes["ssm_chunk"] = 1024
    return dataclasses.replace(cfg, **changes) if changes else cfg


def grad_accum_for(cfg: ModelConfig, shape: ShapeSpec, dp_total: int) -> int:
    """Pick accumulation so the per-device microbatch is ~1 sample for wide
    models (bounds activation memory)."""
    per_dev = max(shape.batch // dp_total, 1)
    if cfg.d_model >= 2048 or shape.seq >= 8192:
        return per_dev  # 1 sample / device / microstep
    return max(per_dev // 4, 1)


def _i32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=_META)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
    """Abstract batch (meta tensors) + logical axes per input."""
    B, S = shape.batch, shape.seq
    act = torch.bfloat16
    if shape.kind == "decode":
        specs = {"tokens": _i32(B, 1)}
        axes = {"tokens": ("batch", None)}
        if cfg.mrope_sections:
            specs["mrope_positions"] = _i32(B, 3, 1)
            axes["mrope_positions"] = ("batch", None, None)
        return specs, axes
    if cfg.kind == "encdec":
        enc = S // STUB_DIV  # post-conv frame stub
        specs = {
            "audio_embeds": torch.empty((B, enc, cfg.d_model), dtype=act,
                                        device=_META),
            "tokens": _i32(B, WHISPER_DEC_LEN),
        }
        axes = {
            "audio_embeds": ("batch", "enc_seq", None),
            "tokens": ("batch", None),
        }
        return specs, axes
    specs = {"tokens": _i32(B, S)}
    axes = {"tokens": ("batch", None)}
    if cfg.vision_stub:
        nv = S // STUB_DIV
        specs["vision_embeds"] = torch.empty((B, nv, cfg.d_model), dtype=act,
                                             device=_META)
        specs["positions"] = _i32(B, 3, S)
        axes["vision_embeds"] = ("batch", None, None)
        axes["positions"] = ("batch", None, None)
    return specs, axes


def _stacked(state, n: int):
    """A cache (a NamedTuple of tensors) with a leading ``n`` dimension."""
    return type(state)(*(torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                     device=_META) for t in state))


def cache_abstract(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> Dict:
    """Abstract decode-cache tree (meta tensors, no allocation) in the
    reference's layout: ``stack`` (each period sublayer's cache with a
    leading ``n_periods`` dimension), ``rest``, and for an
    encoder-decoder ``cross`` (K/V over ``max_len // STUB_DIV`` frames)."""

    def one(mixer):
        return tf._sublayer_cache(cfg, mixer, batch, max_len, dtype, _META)

    caches: Dict[str, Any] = {}
    if cfg.n_periods > 0:
        caches["stack"] = {str(i): _stacked(one(mixer), cfg.n_periods)
                           for i, (mixer, _) in enumerate(cfg.period)}
    caches["rest"] = {str(i): one(mixer)
                      for i, (mixer, _) in enumerate(cfg.remainder)}
    if cfg.kind == "encdec":
        # cross K/V per decoder layer, filled by prefill
        nkv, hd = cfg.n_kv_heads, cfg.hd
        Se = max_len // STUB_DIV

        def kv(*lead):
            return {n: torch.empty(lead + (batch, Se, nkv, hd), dtype=dtype,
                                   device=_META) for n in ("k", "v")}

        cross: Dict[str, Any] = {}
        if cfg.n_periods > 0:
            cross["stack"] = {str(i): kv(cfg.n_periods)
                              for i in range(len(cfg.period))}
        cross["rest"] = {str(i): kv() for i in range(len(cfg.remainder))}
        caches["cross"] = cross
    return caches


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    return fn(path, tree)


def tree_leaves_with_path(tree, path=()) -> Iterator[Tuple[Tuple[str, ...],
                                                           Any]]:
    """(path, leaf) of a cache tree in ``jax.tree.leaves``' order: dict
    keys sorted, NamedTuple fields in order.  A leaf is anything else (a
    tensor, or an axes tuple of :func:`cache_axes`)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from tree_leaves_with_path(getattr(tree, f), path + (f,))
    else:
        yield path, tree


def cache_axes(cfg: ModelConfig, caches) -> Any:
    """Logical axes tree matching the cache tree structure."""

    def leaf_axes(keys, leaf) -> Tuple[Optional[str], ...]:
        stacked = keys[0] == "stack" or (keys[0] == "cross"
                                         and keys[1] == "stack")
        name = keys[-1]
        rank = len(leaf.shape)
        if "cross" in keys:
            base = ("batch", "enc_seq", "kv_heads", None)
        elif name in ("k", "v"):
            base = ("batch", "cache_seq", "kv_heads", None)
        else:
            # recurrent state: batch first, then greedily try "model" via
            # the "inner" rule on remaining dims (resolve_axes keeps the
            # first dim it divides)
            base = ("batch",) + ("inner",) * (rank - 1 - (1 if stacked else 0))
        if stacked:
            base = ("layers",) + base
        # pad/trim to rank
        if len(base) < rank:
            base = base + (None,) * (rank - len(base))
        return base[:rank]

    return _map_with_path(leaf_axes, caches)


def rules_for(cfg: ModelConfig, shape: ShapeSpec) -> Rules:
    if shape.kind == "decode" and shape.batch < 16:
        return long_decode_rules()
    return dict(BASE_RULES)
