"""Launcher of the CUDA selective-scan kernel (``csrc/selective_scan.cu``).

Mamba's scan has no Pallas kernel in the JAX package (it is
``jax.lax.associative_scan`` there); this kernel is the port's own.  CUDA
tensors only; see :mod:`repro_torch.kernels.jacobi_stencil` for the
launcher contract.  ``dt`` and ``xc`` are contiguous ``(B, S, d_inner)``
in float32 or bfloat16, ``Bm`` and ``Cm`` ``(B, S, d_state)`` in the same
type with a unit-stride state (the model's views of its ``x_proj``
output are read in place), ``A`` a contiguous float32 ``(d_inner,
d_state)`` and ``h0`` None or a contiguous float32 ``(B, d_inner,
d_state)``.  Returns ``y`` (B, S, d_inner) and the final state ``h``
(B, d_inner, d_state), both new float32 tensors, from one launch.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import I64, PTR

__all__ = ["selective_scan", "D_STATES"]

#: state sizes the kernel is instantiated for (Jamba's and the reduced
#: configs')
D_STATES = (8, 16)

_ENTRY = {torch.float32: "rt_selective_scan_f32",
          torch.bfloat16: "rt_selective_scan_bf16"}


def selective_scan(dt, xc, Bm, Cm, A, h0=None):
    """The selective scan on the card: ``(y, h)``, both float32."""
    if dt.dtype not in _ENTRY:
        raise ValueError(f"dt has dtype {dt.dtype}, expected float32 or "
                         f"bfloat16")
    B, S, di = dt.shape
    ds = A.shape[1]
    if ds not in D_STATES:
        raise ValueError(f"d_state {ds} not supported (one of {D_STATES})")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid (65535)")
    fn = _build.function(_ENTRY[dt.dtype], [PTR] * 8 + [I64] * 8 + [PTR])
    _build.require(dict(dt=dt, xc=xc), dt.dtype, dt.device)
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != dt.dtype or t.device != dt.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"{dt.dtype} on {dt.device}")
        if t.stride(2) != 1:
            raise ValueError(f"{name}'s state dim must be unit-stride")
    floats = dict(A=A) if h0 is None else dict(A=A, h0=h0)
    _build.require(floats, torch.float32, dt.device)
    y = torch.empty((B, S, di), dtype=torch.float32, device=dt.device)
    h = torch.empty((B, di, ds), dtype=torch.float32, device=dt.device)
    with torch.cuda.device(dt.device):
        err = fn(dt.data_ptr(), xc.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 A.data_ptr(), None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), h.data_ptr(), B, S, di, ds, Bm.stride(0),
                 Bm.stride(1), Cm.stride(0), Cm.stride(1),
                 _build.stream_of(dt))
    _build.check(err, "selective_scan")
    return y, h
