"""Launcher of the expert-indexed MoE products (``csrc/moe_expert_ffn.cu``).

A MoE layer's dropless decode has no Pallas kernel in the JAX package
(its ``moe_ffn(dropless=True)`` runs einsums over all experts); this
kernel is the port's own.  CUDA tensors only; see
:mod:`repro_torch.kernels.jacobi_stencil` for the launcher contract.
``x`` (T, d), ``wi`` (E, d, 2, f) for a gated activation or (E, d, f),
``wo`` (E, f, d), all contiguous in float32 or bfloat16, and ``used`` a
contiguous int32 mask of at least E entries, read on the card.  Returns
``out`` (E, T, d), a new tensor whose rows of the experts with ``used``
0 are left unwritten, from two launches (the first product with its
activation into an (E, T, f) scratch tensor, then the second).
"""

from __future__ import annotations

import torch

from . import _build
from ._build import I64, PTR

__all__ = ["moe_expert_ffn", "ACT_CODES"]

#: activation -> the kernel's code (gelu is the tanh approximation)
ACT_CODES = {"swiglu": 0, "geglu": 1, "gelu": 1, "relu2": 2}

_ENTRY = {torch.float32: "rt_moe_expert_ffn_f32",
          torch.bfloat16: "rt_moe_expert_ffn_bf16"}


def moe_expert_ffn(x, wi, wo, used, act: str):
    """The picked experts' FFN on the card: ``out`` (E, T, d)."""
    if x.dtype not in _ENTRY:
        raise ValueError(f"x has dtype {x.dtype}, expected float32 or "
                         f"bfloat16")
    fn = _build.function(_ENTRY[x.dtype], [PTR] * 6 + [I64] * 6 + [PTR])
    _build.require(dict(x=x, wi=wi, wo=wo), x.dtype, x.device)
    _build.require(dict(used=used), torch.int32, x.device)
    T, d = x.shape
    E, f = wo.shape[:2]
    if E > 65535 or max(d, f) > 65535 * 64:
        raise ValueError(f"{E} experts, d {d} or f {f} exceed the kernel's "
                         f"grid (65535 experts, 65535 column tiles of 64)")
    if x.dtype == torch.bfloat16:  # rows of whole 16-byte chunks
        if d % 8 or f % 8:
            raise ValueError(f"d {d} and f {f} must be multiples of 8")
        for name, t in (("x", x), ("wi", wi), ("wo", wo)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
    h = torch.empty((E, T, f), dtype=x.dtype, device=x.device)
    out = torch.empty((E, T, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wi.data_ptr(), wo.data_ptr(), used.data_ptr(),
                 h.data_ptr(), out.data_ptr(), E, T, d, f,
                 int(wi.ndim == 4), ACT_CODES[act], _build.stream_of(x))
    _build.check(err, "moe_expert_ffn")
    return out
