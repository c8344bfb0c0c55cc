"""Parameter declaration and materialization for the port's LM stack.

Counterpart of ``repro.models.common``: spec functions produce trees (nested
dicts) of :class:`ParamSpec` (shape + logical axes + initializer), the same
trees as the reference, and :func:`materialize` turns one into tensors
drawn from an explicit ``torch.Generator`` on an explicit device.  The
reference's random draws come from ``jax.random`` and differ from these;
tests that compare the two packages carry the reference's arrays over
with :func:`repro_torch.convert.lm_params_from_arrays` instead.

:func:`use_mesh` activates a mesh of ranks for the calls under it,
with the rule table and the global batch of its caches, :func:`current_mesh`
reads it (the MoE layers take the expert-parallel all-to-all under a
mesh with a ``"model"`` axis) and :func:`model_axis` gives the layers
its ``"model"`` group, size and this rank's index.  A layer splits its
work over ``"model"`` where its parameters are this rank's slices
(narrower than the config's whole widths, as ``transformer.shard_params``
cuts them); with whole parameters, or with no mesh, every layer is the
one-rank code.  :func:`cache_axis` gives the mesh axes that a cache's
sequence dimension (``"cache_seq"``, or ``"enc_seq"`` for Whisper's
cross K/V) lands on under the active rules (``"model"``, or ``("data",
"model")`` under ``long_decode_rules``), their joint group and this
rank's index on them: the rule table is read for the caches' layout
only.  The reference's ``axis_rules`` also places activations through
its ``shard`` constraints, which have no counterpart: a rank computes on
its own local tensors.
:class:`ParamTree` holds a materialized tree as an ``nn.Module`` whose
``tree["key"]`` access matches the reference's parameter dicts, so the
layer functions read either.

:class:`FlatParams` is the counterpart of ``jax.flatten_util.ravel_pytree``
for training: it makes every parameter a view into one flat buffer (and
every gradient a view into a second one), laid out leaf by leaf in the
order the reference ravels its parameter tree, so θ, its gradient and the
optimizer state are flat vectors in the reference's order.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
from torch import nn

from .._device import to_device

__all__ = ["ParamSpec", "ParamTree", "FlatLeaf", "FlatParams", "leaves",
           "materialize", "stack_specs", "tree_map", "use_mesh",
           "current_mesh", "current_rules", "ModelAxis", "model_axis",
           "enter", "leave",
           "SeqAxis", "cache_axis", "seq_axis"]

Axes = Tuple[Optional[str], ...]

_ctx = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, rules=None, batch: Optional[int] = None):
    """Activate a mesh of ranks (a ``distributed.sharding.Mesh``; None is
    one rank) for this thread's calls under it.  ``rules`` (default the
    baseline's) and ``batch``, the global batch (default: one that the
    data axes divide, as the step builders split it), place the caches
    the calls make (:func:`cache_axis`)."""
    prev = (current_mesh(), getattr(_ctx, "rules", None),
            getattr(_ctx, "batch", None))
    _ctx.mesh, _ctx.rules, _ctx.batch = mesh, rules, batch
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules, _ctx.batch = prev


def current_mesh():
    return getattr(_ctx, "mesh", None)


def current_rules():
    """The active rule table (the baseline's unless :func:`use_mesh` was
    given one)."""
    rules = getattr(_ctx, "rules", None)
    if rules is None:
        from ..distributed.sharding import BASE_RULES

        rules = BASE_RULES
    return rules


class ModelAxis(NamedTuple):
    """The active mesh's ``"model"`` axis: its process group, its size
    and this rank's index on it."""

    group: Any
    size: int
    index: int


def enter(x: torch.Tensor, ax: Optional[ModelAxis]) -> torch.Tensor:
    """The input of a region split over ``ax`` (a column-parallel product,
    or a whole weight each rank uses for its share of the work): ``x``,
    whose gradient is summed over the ranks
    (``collectives.replicated_param``); ``x`` itself without a split."""
    if ax is None:
        return x
    from ..distributed import collectives as coll

    return coll.replicated_param(x, ax.group)


def leave(y: torch.Tensor, ax: Optional[ModelAxis]) -> torch.Tensor:
    """The output of a row-parallel product: the ranks' partial sums
    added (``collectives.reduce``); ``y`` itself without a split."""
    if ax is None:
        return y
    from ..distributed import collectives as coll

    return coll.reduce(y, ax.group)


def model_axis() -> Optional[ModelAxis]:
    """The active mesh's ``"model"`` axis, or None without a mesh, without
    that axis or when it holds one rank."""
    mesh = current_mesh()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return ModelAxis(mesh.group("model"), mesh.shape["model"],
                     mesh.coord("model"))


class SeqAxis(NamedTuple):
    """The mesh axes a cache's sequence dimension is split over (in the
    partition spec's order, the major first, as they are in the mesh),
    their joint process group, its size and this rank's index in it (the
    piece of the sequence it holds)."""

    axes: Tuple[str, ...]
    group: Any
    size: int
    index: int


def seq_axis(axes, mesh=None) -> Optional[SeqAxis]:
    """:class:`SeqAxis` of ``axes`` (a partition-spec entry: None, a mesh
    axis or a tuple of them) on ``mesh`` (default the active one); None
    when they hold one rank."""
    mesh = current_mesh() if mesh is None else mesh
    if axes is None or mesh is None:
        return None
    axes = axes if isinstance(axes, tuple) else (axes,)
    if tuple(a for a in mesh.axes if a in axes) != axes:
        raise ValueError(f"cache axes {axes} are not in the mesh's order "
                         f"{mesh.axes}")
    size = int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64))
    if size == 1:
        return None
    return SeqAxis(axes, mesh.group(axes), size, mesh.coord(axes))


def cache_axis(name: str, length: int) -> Optional[SeqAxis]:
    """Where the ``name`` dimension (``"cache_seq"`` or ``"enc_seq"``) of a
    ``(batch, length, kv_heads, head_dim)`` cache lands under the active
    rules and mesh: the port's ``resolve_axes`` of ``("batch", name)``
    on ``(global batch, length)`` (so an axis drops out when the mesh
    lacks it, when the batch took it, or when it does not divide
    ``length``); None without a mesh or where the dimension stays
    whole."""
    mesh = current_mesh()
    if mesh is None:
        return None
    from ..distributed.sharding import resolve_axes

    batch = getattr(_ctx, "batch", None)
    if batch is None:  # split over every data axis
        batch = int(np.prod(mesh.sizes, dtype=np.int64))
    spec = resolve_axes(("batch", name), (batch, length), current_rules(),
                        mesh)
    return seq_axis(spec[1], mesh)


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Axes  # logical axis names, len == len(shape)
    init: str = "normal"  # "normal" | "zeros" | "ones" | "embed" | "scaled"
    dtype: torch.dtype = torch.float32

    def scale(self) -> float:
        if self.init == "normal":
            # fan-in scaled truncated-normal-ish init
            fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[-1], 1)
            return 1.0 / np.sqrt(max(fan_in, 1))
        if self.init == "embed":
            return 1.0
        if self.init == "scaled":
            fan_in = int(np.prod(self.shape[:-1]))
            return 1.0 / np.sqrt(max(fan_in, 1))
        return 0.0


def tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` applied to every leaf of a nested dict (keys kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order, as ``jax.tree.flatten``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def materialize(tree, generator: torch.Generator, device=None, dtype=None,
                shardings=None):
    """Instantiate a ParamSpec tree as tensors on ``device``.

    Normal-initialized leaves are drawn from ``generator`` (which must live
    on ``device``) in sorted-key order, then scaled in place.  With
    ``shardings`` (a matching tree of ``distributed.sharding.Sharding``
    on a mesh of ranks) each leaf is drawn whole and only this rank's
    piece of it is kept (a copy), so the draws are the whole tree's and no
    more than one whole leaf is held at a time.
    """
    cut = None
    if shardings is not None:
        from ..distributed.sharding import local_slice

        flat = dict(leaves(shardings))

        def cut(path, t):
            return local_slice(t, flat[path]).clone(
                memory_format=torch.contiguous_format)
    out: Dict = {}
    for path, spec in leaves(tree):
        dt = dtype or spec.dtype
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=dt, device=device)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=dt, device=device)
        else:
            t = torch.randn(spec.shape, generator=generator, dtype=dt,
                            device=device).mul_(float(spec.scale()))
        if cut is not None:
            t = cut(path, t)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def stack_specs(tree, n: int):
    """Add a leading stacked-layer dimension to every spec in the tree."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                            s.dtype), tree)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: tensor leaves are parameters
    (``requires_grad=False`` until a :class:`FlatParams` makes them
    trainable), dict children are sub-``ParamTree``s, and ``tree["key"]``
    reads either."""

    def __init__(self, tree: Dict):
        super().__init__()
        self._keys = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v), requires_grad=False))

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def keys(self):
        return self._keys


@dataclass(frozen=True)
class FlatLeaf:
    """One leaf of the reference's parameter tree inside a flat vector:
    its path, its shape there (stacked leaves keep their leading
    ``n_periods``), its slice ``[start, stop)`` and whether it holds the
    whole leaf (False for this rank's ``"model"`` slice of it)."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    start: int
    stop: int
    whole: bool = True


class FlatParams:
    """Parameters as views into one flat float32 buffer (``dtype``; a
    float64 one holds an exact yardstick), in a given order.

    ``segments`` lists, leaf by leaf, the reference path and shape of a
    leaf and the parameters that make it up, in order (a stacked leaf is
    the same parameter of every period), and optionally whether they
    hold the whole leaf (:attr:`FlatLeaf.whole`, default True). Each
    parameter's data is copied into its slice of :attr:`theta` and
    rebound to that view, its ``.grad`` is set to the same slice of
    :attr:`grad` (autograd then accumulates into it in place) and it is
    made trainable. So :meth:`unravel` is one copy (and cast) into
    :attr:`theta`, and a backward pass leaves the flat gradient in
    :attr:`grad`. Zero it with ``flat.grad.zero_()``, never
    ``Module.zero_grad()``, which would unbind the views.
    """

    def __init__(self, segments: Sequence[Tuple],
                 dtype: torch.dtype = torch.float32):
        params = [p for seg in segments for p in seg[2]]
        if not params:
            raise ValueError("no parameters to flatten")
        device = params[0].device
        n = sum(p.numel() for p in params)
        self.theta = torch.empty(n, dtype=dtype, device=device)
        self.grad = torch.zeros(n, dtype=dtype, device=device)
        self.leaves: List[FlatLeaf] = []
        off = 0
        for path, shape, parts, *whole in segments:
            start = off
            for p in parts:
                k = p.numel()
                view = self.theta[off:off + k].view(p.shape)
                with torch.no_grad():
                    view.copy_(p.data)
                p.data = view
                p.requires_grad_(True)
                p.grad = self.grad[off:off + k].view(p.shape)
                off += k
            if off - start != int(np.prod(shape)):
                raise ValueError(f"{'/'.join(path)}: parameters hold "
                                 f"{off - start} elements, shape {shape}")
            self.leaves.append(FlatLeaf(tuple(path), tuple(shape), start,
                                        off, bool(whole[0]) if whole
                                        else True))
        self.n = n
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.theta.device

    def bound(self) -> bool:
        """Whether every parameter and its ``.grad`` are still views of
        :attr:`theta` and :attr:`grad`.  A ``copy.deepcopy`` or a
        ``Module.to`` of the model gives its parameters storage of their
        own, which ``unravel`` and the backward pass would no longer
        reach."""
        off = 0
        for p in self.params:
            if (p.data_ptr() != self.theta[off:].data_ptr() or p.grad is None
                    or p.grad.data_ptr() != self.grad[off:].data_ptr()):
                return False
            off += p.numel()
        return True

    def ravel(self) -> torch.Tensor:
        """θ as a flat float32 vector (a copy)."""
        return self.theta.clone()

    def unravel(self, theta) -> None:
        """Load a flat vector (host array or tensor, any float dtype) into
        every parameter."""
        if not isinstance(theta, torch.Tensor):
            theta = to_device(theta, self.device)
        if theta.shape != (self.n,):
            raise ValueError(f"expected a flat ({self.n},) vector, got "
                             f"{tuple(theta.shape)}")
        with torch.no_grad():
            self.theta.copy_(theta)

    def tree(self, flat: Optional[torch.Tensor] = None) -> Dict:
        """``flat`` (default θ) as the reference's nested dict, each leaf a
        view of its slice in the reference's shape."""
        flat = self.theta if flat is None else flat
        out: Dict = {}
        for leaf in self.leaves:
            node = out
            for k in leaf.path[:-1]:
                node = node.setdefault(k, {})
            node[leaf.path[-1]] = flat[leaf.start:leaf.stop].view(leaf.shape)
        return out

    def ravel_tree(self, tree: Dict, dtype=torch.float32) -> torch.Tensor:
        """The inverse of :meth:`tree`: a nested dict of arrays in the
        reference's shapes (numpy arrays, bfloat16 ones too, go through
        float32 exactly) as one flat ``dtype`` tensor on this device."""
        out = torch.empty(self.n, dtype=dtype, device=self.device)
        for leaf in self.leaves:
            node = tree
            for k in leaf.path:
                node = node[k]
            a = (node if isinstance(node, torch.Tensor)
                 else torch.from_numpy(np.array(node, np.float32)))
            if tuple(a.shape) != leaf.shape:
                raise ValueError(f"{'/'.join(leaf.path)}: expected shape "
                                 f"{leaf.shape}, got {tuple(a.shape)}")
            out[leaf.start:leaf.stop].copy_(a.reshape(-1))
        return out
