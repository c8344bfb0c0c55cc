"""Parameter declaration and materialization for the port's LM stack.

Counterpart of ``repro.models.common``: spec functions produce trees (nested
dicts) of :class:`ParamSpec` (shape + logical axes + initializer), the same
trees as the reference, and :func:`materialize` turns one into tensors
drawn from an explicit ``torch.Generator`` on an explicit device.  The
reference's random draws come from ``jax.random`` and differ from these;
tests that compare the two packages carry the reference's arrays over
with :func:`repro_torch.convert.lm_params_from_arrays` instead.

There are no mesh rules here: the reference's ``shard`` is a no-op
outside a mesh, and sharding waits for the multi-card item of ROADMAP.md.
:class:`ParamTree` holds a materialized tree as an ``nn.Module`` whose
``tree["key"]`` access matches the reference's parameter dicts, so the
layer functions read either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["ParamSpec", "ParamTree", "materialize", "stack_specs",
           "tree_map"]

Axes = Tuple[Optional[str], ...]


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


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted-key order, as ``jax.tree.flatten``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def materialize(tree, generator: torch.Generator, device=None, dtype=None):
    """Instantiate a ParamSpec tree as tensors on ``device``.

    Normal-initialized leaves are drawn from ``generator`` (which must live
    on ``device``) in sorted-key order, then scaled in place.
    """
    out: Dict = {}
    for path, spec in _leaves(tree):
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
    (``requires_grad=False``: the port serves, it does not train yet),
    dict children are sub-``ParamTree``s, and ``tree["key"]`` reads
    either."""

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
