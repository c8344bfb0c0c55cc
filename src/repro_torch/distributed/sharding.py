"""Logical-axis sharding rules for the production meshes (DP/FSDP/TP/EP/SP):
the rule tables and their resolution against a mesh's axis sizes.

Counterpart of ``repro.distributed.sharding``, its pure part only.  A
rule table maps logical axis names (used by ``ParamSpec`` declarations
and cache axes) to mesh axes.  :func:`resolve_axes` turns one tensor's
logical axes into a partition spec, dropping mesh axes that don't divide
a dimension (e.g. 8 KV heads on a 16-way "model" axis -> replicated, as
designed for GQA); :func:`bytes_per_device` sums a ``ParamSpec`` tree's
bytes on one device under the rules.

A *mesh* here is anything with a ``.shape`` mapping from axis name to
size, such as :class:`MeshShape` (``launch/mesh.py`` builds them); these
functions read nothing else, so the reference's and the port's accept
the same object.  A partition spec is a tuple (the reference returns a
``PartitionSpec``) whose entries are None, a mesh axis or a tuple of
mesh axes.

Baseline rule set (the dry run's variants edit it):
  batch        -> ("pod", "data")     data parallel across pods
  embed        -> "data"              FSDP / ZeRO-3 weight sharding
  vocab/heads/ffn/experts/inner -> "model"   tensor / expert parallel
  cache_seq    -> "model" (+ "data" when batch can't fill the data axis —
                  sequence parallelism for long-context decode)

The rest of the reference module needs more than one card and waits for
ROADMAP.md item 1.6: the band-sharded Jacobi sweep (``band_mesh``,
``band_sharded_jacobi_sweeps``), ``spec_tree_to_shardings`` and
``sharding_for`` (placements on a device mesh) and the collectives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.common import ParamSpec, leaves

__all__ = ["Rules", "BASE_RULES", "MeshShape", "long_decode_rules",
           "resolve_axes", "shards_of", "bytes_per_device"]

Rules = Dict[str, Any]

BASE_RULES: Rules = {
    "batch": ("pod", "data"),
    "embed": "data",  # FSDP
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "ffn_act": "model",
    "experts": "model",  # EP
    "expert_ffn": None,
    "expert_ffn_act": None,
    "expert_capacity": None,  # "data" = capacity-sharded EP (variant)
    "inner": "model",  # mamba/xlstm inner dim
    "layers": None,
    "cache_seq": "model",
    "enc_seq": "model",
}


@dataclass(frozen=True)
class MeshShape:
    """A device mesh's axis names and sizes, without devices: ``shape``
    maps each axis to its size in order (as a JAX ``Mesh.shape`` does)."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    shape: Mapping[str, int] = field(init=False, compare=False)

    def __post_init__(self):
        if len(self.axes) != len(self.sizes):
            raise ValueError(f"{len(self.axes)} axes, {len(self.sizes)} sizes")
        object.__setattr__(self, "shape", dict(zip(self.axes, self.sizes)))

    @property
    def size(self) -> int:
        """The number of devices."""
        return int(np.prod(self.sizes, dtype=np.int64))

    def __str__(self) -> str:
        return "x".join(map(str, self.sizes))


def long_decode_rules() -> Rules:
    """Sequence parallelism for batch-1 long decode: KV over data+model."""
    r = dict(BASE_RULES)
    r["cache_seq"] = ("data", "model")
    return r


def resolve_axes(
    axes: Tuple[Optional[str], ...],
    shape: Tuple[int, ...],
    rules: Rules,
    mesh,
) -> Tuple:
    """Logical axes + shape -> partition spec (a tuple, one entry a dim).

    Drops a mesh axis if (a) it isn't in the mesh, (b) it was already used
    by an earlier dimension of this tensor, or (c) it doesn't divide the
    dimension (predictable replication instead of padding).
    """
    used: set = set()
    parts = []
    for dim, ax in zip(shape, axes):
        rule = rules.get(ax) if ax is not None else None
        if rule is None:
            parts.append(None)
            continue
        cand = rule if isinstance(rule, tuple) else (rule,)
        cand = tuple(a for a in cand if a in mesh.shape and a not in used)
        # greedy prefix that divides the dimension
        keep = []
        size = 1
        for a in cand:
            if dim % (size * mesh.shape[a]) == 0:
                keep.append(a)
                size *= mesh.shape[a]
        if not keep:
            parts.append(None)
        elif len(keep) == 1:
            used.add(keep[0])
            parts.append(keep[0])
        else:
            used.update(keep)
            parts.append(tuple(keep))
    return tuple(parts)


def shards_of(spec: Tuple, mesh) -> int:
    """How many pieces a partition spec cuts a tensor into."""
    shards = 1
    for part in spec:
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            shards *= mesh.shape[a]
    return shards


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def bytes_per_device(spec_tree, rules: Rules, mesh) -> int:
    """Estimated per-device bytes of a ParamSpec tree under the rules."""
    total = 0
    for _, s in leaves(spec_tree):
        if not isinstance(s, ParamSpec):
            raise TypeError(f"expected ParamSpec leaves, got {type(s)}")
        shards = shards_of(resolve_axes(s.axes, s.shape, rules, mesh), mesh)
        total += int(np.prod(s.shape)) * _itemsize(s.dtype) // shards
    return total
