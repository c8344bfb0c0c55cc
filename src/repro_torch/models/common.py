"""Parameter declaration and materialization for the port's LM stack.

Counterpart of ``repro.models.common``: spec functions produce trees (nested
dicts) of :class:`ParamSpec` (shape + logical axes + initializer), the same
trees as the reference, and :func:`materialize` turns one into tensors
drawn from an explicit ``torch.Generator`` on an explicit device.  The
reference's random draws come from ``jax.random`` and differ from these;
tests that compare the two packages carry the reference's arrays over
with :func:`repro_torch.convert.lm_params_from_arrays` instead.

:func:`use_mesh` activates a mesh of ranks for the calls under it and
:func:`current_mesh` reads it (the MoE layers take the expert-parallel
all-to-all under a mesh with a ``"model"`` axis).  The reference's
``axis_rules`` also activates a rule table for its ``shard`` activation
constraints, which have no counterpart: a rank computes on its own local
tensors, so no layer reads a rule.
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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .._device import to_device

__all__ = ["ParamSpec", "ParamTree", "FlatLeaf", "FlatParams", "leaves",
           "materialize", "stack_specs", "tree_map", "use_mesh",
           "current_mesh"]

Axes = Tuple[Optional[str], ...]

_ctx = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a mesh of ranks (a ``distributed.sharding.Mesh``; None is
    one rank) for this thread's calls under it."""
    prev = current_mesh()
    _ctx.mesh = mesh
    try:
        yield
    finally:
        _ctx.mesh = prev


def current_mesh():
    return getattr(_ctx, "mesh", None)


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


def materialize(tree, generator: torch.Generator, device=None, dtype=None):
    """Instantiate a ParamSpec tree as tensors on ``device``.

    Normal-initialized leaves are drawn from ``generator`` (which must live
    on ``device``) in sorted-key order, then scaled in place.
    """
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
    ``n_periods``) and its slice ``[start, stop)``."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    start: int
    stop: int


class FlatParams:
    """Parameters as views into one flat float32 buffer, in a given order.

    ``segments`` lists, leaf by leaf, the reference path and shape of a
    leaf and the parameters that make it up, in order (a stacked leaf is
    the same parameter of every period).  Each parameter's data is copied
    into its slice of :attr:`theta` and rebound to that view, its
    ``.grad`` is set to the same slice of :attr:`grad` (autograd then
    accumulates into it in place) and it is made trainable.  So
    :meth:`unravel` is one copy (and cast) into :attr:`theta`, and a
    backward pass leaves the flat gradient in :attr:`grad`.  Zero it with
    ``flat.grad.zero_()``, never ``Module.zero_grad()``, which would unbind
    the views.
    """

    def __init__(self, segments: Sequence[Tuple[Tuple[str, ...],
                                                Tuple[int, ...],
                                                Sequence[nn.Parameter]]]):
        params = [p for _, _, parts in segments for p in parts]
        if not params:
            raise ValueError("no parameters to flatten")
        device = params[0].device
        n = sum(p.numel() for p in params)
        self.theta = torch.empty(n, dtype=torch.float32, device=device)
        self.grad = torch.zeros(n, dtype=torch.float32, device=device)
        self.leaves: List[FlatLeaf] = []
        off = 0
        for path, shape, parts in segments:
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
                                        off))
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
