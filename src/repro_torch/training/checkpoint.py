"""Training checkpoints in the reference's file format.

Counterpart of ``repro.training.checkpoint``: atomic step directories
(``.tmp-<step>`` then ``os.replace`` to ``step_%08d``), one compressed
``arrays.npz`` plus a ``manifest.json`` (step, keys, dtypes, shapes,
extra), keep-last-k retention and optional background saves.  A leaf's
key joins its path with ``|`` as ``jax.tree_util.tree_flatten_with_path``
names it (dict keys, tuple indices, NamedTuple field names), and
bfloat16 is stored as raw bytes with its dtype and shape in the manifest,
so a checkpoint of ``(params, opt_state)`` written by either package
restores in the other.

Trees are nested dicts, tuples, lists and NamedTuples whose leaves are
tensors, numpy arrays or Python numbers.  :func:`restore` returns the
template's structure with each leaf a tensor (on a tensor template
leaf's device and in its dtype).  With ``shardings`` (a matching tree of
:class:`~repro_torch.distributed.sharding.Sharding` leaves) each rank
gets its own piece of every leaf: the file holds whole leaves, so a
checkpoint saved on any layout (either package's, one rank's or a
gathered sharded run's) restores onto any other (elastic resume).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_SEP = "|"


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util`` order; None is an empty
    subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:  # a leaf (a Sharding is a dataclass, not a tuple)
        return [(_SEP.join(prefix), tree)]
    out = []
    for k, v in items:
        out += _flatten(v, prefix + (k,))
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves`` in :func:`_flatten` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _host(leaf) -> Tuple[np.ndarray, str, List[int]]:
    """A leaf as (stored array, dtype name, shape), snapshotted: bfloat16
    (and any dtype numpy's npz cannot hold) as raw bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        shape = list(t.shape)
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint8).reshape(-1).numpy(), "bfloat16", shape
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    if arr.dtype.kind in "fiub" and arr.dtype.name in np.sctypeDict:
        return arr, str(arr.dtype), list(arr.shape)
    return (np.ascontiguousarray(arr).view(np.uint8).reshape(-1),
            str(arr.dtype), list(arr.shape))


def _from_store(arr: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    want = np.dtype(dtype)
    if arr.dtype != want:
        arr = arr.view(want).reshape(shape)
    return torch.from_numpy(arr)


def _write(directory: str, step: int, stored: Dict[str, Tuple],
           extra: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step}")
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez_compressed(os.path.join(tmp, "arrays.npz"),
                        **{k: v[0] for k, v in stored.items()})
    manifest = {
        "step": step,
        "keys": sorted(stored),
        "dtypes": {k: v[1] for k, v in stored.items()},
        "shapes": {k: v[2] for k, v in stored.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return final


def _snapshot(tree) -> Dict[str, Tuple]:
    return {k: _host(leaf) for k, leaf in _flatten(tree)}


def save(directory: str, step: int, tree, extra: Optional[Dict] = None) -> str:
    return _write(directory, step, _snapshot(tree), extra)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None


def _like(arr: torch.Tensor, tmpl):
    if isinstance(tmpl, torch.Tensor):
        device = tmpl.device if tmpl.device.type != "meta" else None
        return arr.to(device=device, dtype=tmpl.dtype)
    return arr


def restore(directory: str, template, step: Optional[int] = None,
            shardings=None) -> Tuple[Any, int, Dict]:
    """Restore into ``template``'s structure, every leaf a tensor (on a
    tensor template leaf's device, the CPU for a meta one, in its dtype).
    ``shardings`` gives each leaf this rank's piece under its
    :class:`~repro_torch.distributed.sharding.Sharding`; the template
    holds whole shapes.  Returns ``(tree, step, extra)``."""
    cuts = [None] * len(_flatten(template))
    if shardings is not None:
        from ..distributed.sharding import Mesh, Sharding, local_slice

        cuts = [s for _, s in _flatten(shardings)]
        if len(cuts) != len(_flatten(template)) or not all(
                isinstance(s, Sharding) for s in cuts):
            raise ValueError("shardings must be a tree of Sharding leaves "
                             "matching the template")
        if not all(isinstance(s.mesh, Mesh) for s in cuts):
            raise ValueError("a sharded restore places leaves on a mesh of "
                             "ranks (distributed.sharding.make_mesh), not "
                             "on a mesh shape")
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(template)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        missing = [k for k, _ in flat if k not in data]
        if missing:
            raise ValueError(f"checkpoint missing keys: {missing[:5]} ...")
        leaves = []
        for (key, tmpl), cut in zip(flat, cuts):
            arr = _from_store(data[key], manifest["dtypes"][key],
                              manifest["shapes"][key])
            want = tuple(tmpl.shape if hasattr(tmpl, "shape")
                         else np.shape(tmpl))
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{tuple(arr.shape)} vs template {want}")
            if cut is not None:
                arr = local_slice(arr, cut).contiguous()
            leaves.append(_like(arr, tmpl))
    return _unflatten(template, iter(leaves)), step, manifest["extra"]


class CheckpointManager:
    """Keep-last-k, optional async saves, restart bookkeeping."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.directory)
            if (m := re.match(r"step_(\d+)$", d)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        stored = _snapshot(tree)  # host copies before the async write

        def work():
            _write(self.directory, step, stored, extra)
            self._gc()

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, template, shardings=None):
        self.wait()
        return restore(self.directory, template, shardings=shardings)
