"""Launchers of the CUDA flash-attention kernels.

Counterpart of ``repro.kernels.flash_attention``.  CUDA tensors only; see
:mod:`repro_torch.kernels.jacobi_stencil` for the launcher contract.
float32 inputs launch the FFMA kernel of ``csrc/flash_attention.cu``,
bfloat16 inputs the tensor-core (wgmma + TMA) kernel of
``csrc/flash_attention_bf16.cu``; there is no other route.  The inputs are
read in place through their strides (the head dim must be unit-stride),
so the GQA layout ``(B, S, heads, hd)`` needs no transpose; the output is
a new contiguous ``(B, Sq, nq, hd)`` tensor in q's dtype.  Both kernels
read rows from 16-byte boundaries in steps of 16 bytes (float32: 16-byte
copies; bfloat16: TMA's tensor maps), so an input that :func:`aligned`
refuses is first copied to a fresh contiguous tensor (views of
projections never are).
"""

from __future__ import annotations

import torch

from . import _build
from ._build import F64, I64, PTR

__all__ = ["flash_attention", "aligned", "HEAD_DIMS"]

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)

_ENTRY = {torch.float32: "rt_flash_attention_f32",
          torch.bfloat16: "rt_flash_attention_bf16"}


def aligned(data_ptr: int, shape, strides, itemsize: int) -> bool:
    """Whether the kernels can read a ``(B, S, heads, hd)`` view in place:
    its start on a 16-byte boundary, and batch, sequence and head strides
    that are multiples of 16 bytes (4 float32 or 8 bfloat16 elements:
    the float32 kernel's 16-byte copies, the bfloat16 kernel's TMA tensor
    maps), and nonzero where the dimension has more than one entry (an
    expanded view is copied rather than encoded in a tensor map).  A pure
    function of the pointer, shape, strides and element size."""
    return (data_ptr % 16 == 0
            and all(s * itemsize % 16 == 0 for s in strides[:3])
            and all(s != 0 for s, n in zip(strides[:3], shape[:3]) if n > 1))


def _aligned(t: torch.Tensor) -> bool:
    return aligned(t.data_ptr(), t.shape, t.stride(), t.element_size())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, softcap=None,
                    q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention on the card (float32 accumulation)."""
    if q.dtype not in _ENTRY:
        raise ValueError(f"q has dtype {q.dtype}, expected float32 or "
                         f"bfloat16")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    B, Sq, nq, hd = q.shape
    Bk, Skv, nkv, hdk = k.shape
    if Bk != B or hdk != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported (one of {HEAD_DIMS})")
    if B == 0 or Sq == 0:
        raise ValueError("empty batch or query length")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be unit-stride")
    fn = _build.function(_ENTRY[q.dtype],
                         [PTR] * 4 + [I64] * 18 + [F64, I64, PTR])
    q, k, v = (t if _aligned(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty((B, Sq, nq, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, nq, nkv, hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], int(bool(causal)), int(window is not None),
                 0 if window is None else int(window),
                 0.0 if softcap is None else float(softcap), int(q_offset),
                 _build.stream_of(q))
    _build.check(err, "flash_attention")
    return out
