"""The weights of a cell, made on the device from the run's seed.

Both sides read the same tensors: the program gets them as its model's
parameters (``port.build_model``), the reference reads them by name.
Each group (the embedding and head, each layer, the final norm) is one
buffer filled by a few large ``normal_`` calls on a generator on the
device, in the type the model is served in; every weight is an aligned
view of its group's buffer, scaled in place by the rule for its name.

The scales keep bfloat16 activations of a random model finite and of
order one: a product's weight is drawn with standard deviation
1/sqrt(fan-in); a norm's scale is 0.1 N(0, 1), so that ``1 + scale``
varies; Mamba's ``A_log`` is ``log(1..d_state)`` (S4D-real), its
``dt_bias`` the inverse softplus of dt drawn log-uniform in [1e-3, 0.1]
and ``D`` is 1 + 0.1 N(0, 1), as Mamba's own initialisation sets them.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

from .spec import ModelSpec, leaf_shapes

__all__ = ["derive_seed", "make_weights"]

#: elements per ``normal_`` call (a few calls fill a layer's buffer)
_CHUNK = 1 << 30
#: every view starts at a multiple of this many elements (256 bytes in
#: bfloat16): the products' kernels read aligned rows
_ALIGN = 128


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of the run's ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _fan_in_scale(path: Tuple, shape: Tuple[int, ...]) -> float:
    name = path[-1]
    if name == "embedding":
        return 1.0
    if name == "unembed":
        return 1 / math.sqrt(shape[0])
    if name in ("wq", "wk", "wv", "in_proj", "router"):
        return 1 / math.sqrt(shape[0])
    if name == "wo" and path[-2] == "mixer":  # attention (nq, hd, d)
        return 1 / math.sqrt(shape[0] * shape[1])
    if name == "wi":  # (d, 2, f) or (E, d, 2, f)
        return 1 / math.sqrt(shape[-3])
    if name == "wo":  # (f, d) or (E, f, d)
        return 1 / math.sqrt(shape[-2])
    if name in ("x_proj", "dt_proj", "out_proj", "conv_w"):
        return 1 / math.sqrt(shape[0])
    if name in ("scale", "conv_b"):
        return 0.1
    raise ValueError(f"no initialisation rule for {'/'.join(map(str, path))}")


def _special(path: Tuple, view: torch.Tensor, gen: torch.Generator) -> bool:
    """Fill Mamba's ``A_log``, ``dt_bias`` and ``D``; False for others."""
    name = path[-1]
    if name == "A_log":
        n = view.shape[1]
        a = torch.arange(1, n + 1, dtype=torch.float32, device=view.device)
        view.copy_(a.log().expand_as(view))
        return True
    if name == "dt_bias":
        u = torch.rand(view.shape, generator=gen, device=view.device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        view.copy_(dt + torch.log(-torch.expm1(-dt)))
        return True
    if name == "D":
        view.mul_(0.1).add_(1.0)
        return True
    return False


def _groups(spec: ModelSpec) -> List[List[Tuple[Tuple, Tuple[int, ...]]]]:
    groups: Dict = {}
    for path, shape in leaf_shapes(spec):
        key = path[:2] if path[0] == "layers" else path[:1]
        groups.setdefault(key, []).append((path, shape))
    return list(groups.values())


def make_weights(spec: ModelSpec, seed: int, device,
                 dtype=torch.bfloat16) -> Dict[Tuple, torch.Tensor]:
    """Every weight of ``spec`` by path (:func:`spec.leaf_shapes`), drawn
    from ``seed`` on ``device``: the same seed gives the same weights."""
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, "weights"))
    out: Dict[Tuple, torch.Tensor] = {}
    for group in _groups(spec):
        offs, n = [], 0
        for _, shape in group:
            offs.append(n)
            n += -(-math.prod(shape) // _ALIGN) * _ALIGN
        buf = torch.empty(n, dtype=dtype, device=device)
        for i in range(0, n, _CHUNK):
            buf[i:i + _CHUNK].normal_(generator=gen)
        for (path, shape), off in zip(group, offs):
            view = buf[off:off + math.prod(shape)].view(shape)
            if not _special(path, view, gen):
                view.mul_(_fan_in_scale(path, shape))
            out[path] = view
    return out
