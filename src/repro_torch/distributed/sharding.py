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

Meshes of ranks.  :func:`make_mesh` builds a :class:`Mesh` over an
initialised ``torch.distributed`` process group (``gloo`` on the CPU,
``nccl`` on the card): a :class:`MeshShape` that also holds this rank's
coordinates and a process group for every set of its axes.  :func:`sharding_for` and :func:`spec_tree_to_shardings`
give each tensor a :class:`Sharding`: its partition spec and one
``Shard(dim)``/``Replicate()`` placement per mesh axis;
:func:`local_slice` cuts a rank's piece out of a full tensor under one.

Band-sharded stencil sweeps.  A Jacobi row block can itself be split
row-band-wise over the local cards (:func:`band_devices`,
:func:`band_sharded_jacobi_sweeps`): every sweep launches the one-sweep
``jacobi_halo_sweeps`` kernel on each band, with the neighbour bands'
current edge rows as its halos, so only the block's two global halo rows
stay frozen and the arithmetic equals the one-band fused sweep byte for
byte.  The reference does this with ``shard_map`` over all local JAX
devices and a ``ppermute`` per sweep; here one process drives a list of
devices (an engine worker is a thread or a process dispatching one block,
not an SPMD rank).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.common import ParamSpec, leaves, tree_map

__all__ = ["Rules", "BASE_RULES", "MeshShape", "Mesh", "make_mesh",
           "Sharding", "long_decode_rules", "resolve_axes", "shards_of",
           "bytes_per_device", "sharding_for", "spec_tree_to_shardings",
           "local_slice", "local_tree", "band_devices",
           "band_sharded_jacobi_sweeps"]

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


# --------------------------------------------------------------------- #
# Meshes of ranks and placements
# --------------------------------------------------------------------- #
@dataclass(frozen=True, eq=False)
class Mesh(MeshShape):
    """A mesh of ``torch.distributed`` ranks (:func:`make_mesh`): the axis
    names and sizes of a :class:`MeshShape`, this rank's coordinate on
    each axis (``coords``) and a process group for every set of axes
    (``groups``, keyed by axis tuples in mesh order).  Ranks lie on the
    mesh in row-major order, the last axis fastest."""

    coords: Mapping[str, int] = field(default=None)
    groups: Mapping[Tuple[str, ...], Any] = field(default=None, repr=False)

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise KeyError(f"axes {unknown} are not in the mesh {self.axes}")
        return tuple(a for a in self.axes if a in axes)

    def group(self, axes):
        """The process group of this rank's line (plane, ...) along
        ``axes``: the ranks that differ from this one on those axes only.
        A group's ranks are numbered by :meth:`coord` on the same axes."""
        return self.groups[self._key(axes)]

    def coord(self, axes) -> int:
        """This rank's index along ``axes`` (mixed radix in mesh order)."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def make_mesh(shape: Sequence[int], names: Sequence[str]) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the initialised default process
    group, whose size must be the mesh's.  The one-axis groups come from
    a ``DeviceMesh`` whose device type follows the backend: ``"cuda"``
    under ``nccl``, else ``"cpu"``.  Every rank must call this, in the same order as its other group
    creations."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"{len(shape)} sizes for {len(names)} axis names")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {shape} holds {int(np.prod(shape))} ranks, "
                         f"the process group {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, shape, mesh_dim_names=names)
    grid = np.arange(world).reshape(shape)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(
        dist.get_rank(), shape))))
    groups: Dict[Tuple[str, ...], Any] = {}
    n = len(names)
    for k in range(1, n + 1):
        for sub in itertools.combinations(range(n), k):
            key = tuple(names[i] for i in sub)
            if k == 1:
                groups[key] = dm.get_group(names[sub[0]])
            elif k == n:
                groups[key] = dist.group.WORLD
            else:
                rest = [i for i in range(n) if i not in sub]
                lines = []
                for fixed in itertools.product(*(range(shape[i])
                                                 for i in rest)):
                    idx = [slice(None)] * n
                    for i, c in zip(rest, fixed):
                        idx[i] = c
                    lines.append(grid[tuple(idx)].reshape(-1).tolist())
                groups[key], _ = dist.new_subgroups_by_enumeration(lines)
    return Mesh(names, shape, coords=coords, groups=groups)


def _axes_of(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


@dataclass(frozen=True, eq=False)
class Sharding:
    """A tensor's layout on a mesh: the partition spec of
    :func:`resolve_axes` (one entry a dimension: None, a mesh axis or a
    tuple of them, the first the major one) on ``mesh`` (a
    :class:`MeshShape` or a :class:`Mesh`)."""

    mesh: Any
    spec: Tuple

    @property
    def placements(self) -> Tuple:
        """One ``Shard(dim)`` or ``Replicate()`` per mesh axis, in mesh
        order (``torch.distributed.tensor``'s placements)."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for a in self.mesh.axes:
            dims = [i for i, part in enumerate(self.spec)
                    if a in _axes_of(part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def sharding_for(shape: Tuple[int, ...], axes, rules: Rules,
                 mesh) -> Sharding:
    return Sharding(mesh, resolve_axes(tuple(axes), tuple(shape), rules,
                                       mesh))


def spec_tree_to_shardings(spec_tree, rules: Rules, mesh):
    """ParamSpec tree -> :class:`Sharding` tree (the same nested dicts)."""
    return tree_map(lambda s: sharding_for(s.shape, s.axes, rules, mesh),
                    spec_tree)


def local_slice(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's piece of the full tensor ``x`` under ``sharding`` (on a
    :class:`Mesh`): a view, cut along each sharded dimension into as many
    pieces as its mesh axes hold ranks (``torch.chunk``'s sizes: the last
    piece may be shorter)."""
    mesh = sharding.mesh
    coords = mesh.coords
    if len(sharding.spec) > x.ndim:
        raise ValueError(f"spec {sharding.spec} for a {x.ndim}-d tensor")
    for dim, part in enumerate(sharding.spec):
        idx, n = 0, 1
        for a in _axes_of(part):
            idx, n = idx * mesh.shape[a] + coords[a], n * mesh.shape[a]
        if n == 1:
            continue
        size = x.shape[dim]
        chunk = -(-size // n)
        start = min(idx * chunk, size)
        x = x.narrow(dim, start, min(chunk, size - start))
    return x


def local_tree(tree, shardings):
    """:func:`local_slice` of every leaf of ``tree`` (nested dicts, tuples,
    lists and NamedTuples of tensors) under the matching
    :class:`Sharding` of ``shardings``; a leaf that is no tensor (a step
    count) stays as it is."""
    if isinstance(tree, dict):
        return {k: local_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [local_tree(v, s) for v, s in zip(tree, shardings)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    if not isinstance(tree, torch.Tensor):
        return tree
    return local_slice(tree, shardings)


# --------------------------------------------------------------------- #
# Band-sharded stencil sweeps
# --------------------------------------------------------------------- #
def band_devices(rows: int, device=None) -> Optional[List[torch.device]]:
    """The local cards to band-shard a block of ``rows`` grid rows over.

    None (the one-band fused path) unless the block lives on a card (or
    ``device`` is None), there are >= 2 cards and they divide ``rows``
    evenly into bands of at least 2 rows: predictable fallback over
    padding, the policy of :func:`resolve_axes` (the reference's
    ``band_mesh``)."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2 or rows % n != 0 or rows < 2 * n:
        return None
    return [torch.device("cuda", i) for i in range(n)]


# A band-sharded dispatch occupies every band's device, so concurrent
# dispatches (thread-backend workers) gain nothing: one at a time, as the
# reference's collective lock.
_BAND_LOCK = threading.Lock()


def band_sharded_jacobi_sweeps(blk: torch.Tensor, top: torch.Tensor,
                               bot: torch.Tensor, bg: torch.Tensor, *,
                               sweeps: int,
                               devices: Sequence) -> Tuple[torch.Tensor,
                                                           float]:
    """``sweeps`` Jacobi sweeps of a (rows, g) float64 block with frozen
    global halos ``top``/``bot``, band-sharded over ``devices`` (one band
    a device, in order; a device may repeat); returns ``(new_block on
    blk's device, sum((new - blk)**2))``.

    Each sweep launches ``ops.jacobi_halo_sweeps(..., sweeps=1)`` on every
    band against its neighbours' current edge rows (copied to its device;
    PyTorch orders a copy between cards after both cards' current streams
    with events, no device-wide synchronise), so every element equals the
    one-band fused sweep's.  The norm is the sum of the bands' sums, as the
    reference's ``psum``; its summation order differs from the one-band
    kernel's in the last bits."""
    from ..kernels import ops

    n = len(devices)
    rows, g = blk.shape
    if n < 1 or rows % n or rows < 2 * n:
        raise ValueError(f"{n} bands do not split {rows} rows into bands "
                         f"of at least 2 equal rows")
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    h = rows // n
    devices = [torch.device(d) for d in devices]
    with _BAND_LOCK:
        start = [blk[i * h:(i + 1) * h].to(d) for i, d in enumerate(devices)]
        bgs = [bg[i * h:(i + 1) * h].to(d) for i, d in enumerate(devices)]
        top, bot = top.to(devices[0]), bot.to(devices[-1])
        cur = start
        for _ in range(sweeps):
            nxt = []
            for i, d in enumerate(devices):
                t = top if i == 0 else cur[i - 1][-1].to(d)
                b = bot if i == n - 1 else cur[i + 1][0].to(d)
                nxt.append(ops.jacobi_halo_sweeps(cur[i], t, b, bgs[i],
                                                  sweeps=1)[0])
            cur = nxt
        sums = [torch.sum(torch.square(c - c0)).to(blk.device)
                for c, c0 in zip(cur, start)]
        new = torch.cat([c.to(blk.device) for c in cur])
        norm = float(torch.stack(sums).sum())
    return new, norm
