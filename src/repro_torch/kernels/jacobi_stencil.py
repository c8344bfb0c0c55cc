"""Launchers of the CUDA Jacobi stencil kernels (``csrc/jacobi_stencil.cu``).

Counterpart of ``repro.kernels.jacobi_stencil``.  These functions take
CUDA tensors only: they check device, dtype and contiguity, allocate the
outputs (and scratch, where a call needs it) with ``torch.empty``, launch
on PyTorch's current stream and never synchronise.  Callers go through
:mod:`repro_torch.kernels.ops`, which also accepts CPU tensors (the plain
version) and counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import I64, PTR

__all__ = ["halo_plan", "jacobi_halo_sweeps", "jacobi_sweep"]


@functools.lru_cache(maxsize=64)
def halo_plan(rows: int, g: int, sweeps: int):
    """``(passes, partials)`` of one ``jacobi_halo_sweeps`` call: the
    kernel launches before the norm's combine pass, and the partial norms
    (CTAs) of the last one."""
    fn = _build.function("rt_jacobi_halo_plan", [I64, I64, I64, PTR])
    out = (ctypes.c_int64 * 2)()
    _build.check(fn(rows, g, sweeps, ctypes.addressof(out)),
                 "jacobi_halo_sweeps (plan)")
    return int(out[0]), int(out[1])


def jacobi_halo_sweeps(xb: torch.Tensor, top: torch.Tensor,
                       bot: torch.Tensor, b: torch.Tensor, *, sweeps: int):
    """``sweeps`` frozen-halo sweeps of a ``(rows, g)`` block on the card;
    returns ``(new_block, sum((new - xb)**2))`` as CUDA tensors."""
    fn = _build.function("rt_jacobi_halo_sweeps",
                         [PTR] * 7 + [I64, PTR, I64, I64, I64, PTR])
    _build.require(dict(xb=xb, top=top, bot=bot, b=b), torch.float64,
                   xb.device)
    rows, g = xb.shape
    passes, partials = halo_plan(rows, g, sweeps)
    out = torch.empty_like(xb)
    scratch = torch.empty_like(xb) if passes > 1 else None
    # the norm, then one partial per CTA of the last pass
    red = torch.empty(1 + partials, dtype=torch.float64, device=xb.device)
    with torch.cuda.device(xb.device):
        err = fn(xb.data_ptr(), top.data_ptr(), bot.data_ptr(), b.data_ptr(),
                 out.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 red.data_ptr() + red.element_size(), partials,
                 red.data_ptr(), rows, g, sweeps, _build.stream_of(xb))
    _build.check(err, "jacobi_halo_sweeps")
    return out, red[0]


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
