"""Device selection and the host <-> device boundary of the port.

The port runs on the CUDA card unless the caller asks for the CPU: a
problem built without ``device=`` lands on ``cuda:0`` and raises when no
card is present.  ``device="cpu"`` is the explicit opt-in the CPU tests
use; there every kernel wrapper takes its plain PyTorch version.

The coordinator keeps the reference engine's contract of flat float64
numpy arrays on the host, so the problems cross the boundary with
:func:`to_device` and :func:`to_host` (``np.asarray`` on a CUDA tensor
fails, which is why every crossing goes through these two).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["has_cuda", "default_device", "resolve_device", "to_device",
           "to_host", "host_float"]


def has_cuda() -> bool:
    """True when PyTorch sees a CUDA device."""
    return torch.cuda.is_available()


def default_device() -> torch.device:
    """``cuda:0``; raises ``RuntimeError`` when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """The device a problem or accelerator state lives on.

    ``None`` means :func:`default_device`.  Only ``cpu`` and ``cuda``
    devices are accepted; a CUDA device without a card raises.
    """
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (expected cpu or cuda)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def to_device(a, device: torch.device) -> torch.Tensor:
    """Host array -> float64 tensor on ``device`` (aliases a writable
    array on the CPU; read-only arrays are copied first)."""
    a = np.asarray(a, dtype=np.float64)
    if not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a, device=device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy array (a device-to-host copy on CUDA)."""
    return t.detach().cpu().numpy()


def host_float(t) -> float:
    """``float(t)`` of a one-element tensor (a copy to the host), or nan
    for a meta tensor, which has a shape and no value (the dry run's
    steps run on the meta device)."""
    if isinstance(t, torch.Tensor) and t.device.type == "meta":
        return float("nan")
    return float(t)
