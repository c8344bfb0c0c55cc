"""Launchers of the CUDA Jacobi stencil kernels (``csrc/jacobi_stencil.cu``).

Counterpart of ``repro.kernels.jacobi_stencil``.  These functions take
CUDA tensors only: they check device, dtype and contiguity, allocate the
outputs and scratch with ``torch.empty``, launch on PyTorch's current
stream and never synchronise.  Callers go through
:mod:`repro_torch.kernels.ops`, which also accepts CPU tensors (the plain
version) and counts launches.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import I64, PTR

__all__ = ["jacobi_halo_sweeps", "jacobi_sweep"]

#: partial-norm slots the C side needs (``rt::kMaxPartials``)
_PARTIALS = 1024


def jacobi_halo_sweeps(xb: torch.Tensor, top: torch.Tensor,
                       bot: torch.Tensor, b: torch.Tensor, *, sweeps: int):
    """``sweeps`` frozen-halo sweeps of a ``(rows, g)`` block on the card;
    returns ``(new_block, sum((new - xb)**2))`` as CUDA tensors."""
    fn = _build.function("rt_jacobi_halo_sweeps",
                         [PTR] * 7 + [I64, PTR, I64, I64, I64, PTR])
    _build.require(dict(xb=xb, top=top, bot=bot, b=b), torch.float64,
                   xb.device)
    rows, g = xb.shape
    out = torch.empty_like(xb)
    scratch = torch.empty_like(xb) if sweeps > 1 else out
    partials = torch.empty(_PARTIALS, dtype=torch.float64, device=xb.device)
    norm = torch.empty((), dtype=torch.float64, device=xb.device)
    with torch.cuda.device(xb.device):
        err = fn(xb.data_ptr(), top.data_ptr(), bot.data_ptr(), b.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
                 _PARTIALS, norm.data_ptr(), rows, g, sweeps,
                 _build.stream_of(xb))
    _build.check(err, "jacobi_halo_sweeps")
    return out, norm


def jacobi_sweep(x: torch.Tensor, b: torch.Tensor, g: int,
                 order: str = "pallas") -> torch.Tensor:
    """One global Dirichlet sweep of a flat ``(g*g,)`` grid on the card, in
    the Pallas kernel's add order or (``order="jnp"``) ``_full_sweep``'s."""
    fn = _build.function("rt_jacobi_sweep", [PTR, PTR, PTR, I64, I64, PTR])
    _build.require(dict(x=x, b=b), torch.float64, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), b.data_ptr(), out.data_ptr(), g,
                 int(order == "jnp"), _build.stream_of(x))
    _build.check(err, "jacobi_sweep")
    return out
