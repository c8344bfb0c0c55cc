"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

- :mod:`repro_torch.kernels.ops`  — public wrappers (route by device, count
  launches)
- :mod:`repro_torch.kernels.ref`  — plain PyTorch versions, numpy oracles
- :mod:`repro_torch.kernels.jacobi_stencil`, ``bellman``, ``anderson_mix``,
  ``flash_attention``, ``selective_scan``, ``moe_expert_ffn`` — ctypes
  launchers of
  ``csrc/*.cu``
- :mod:`repro_torch.kernels._build` — builds ``csrc/`` with ``nvcc`` on
  first use (never at import)
"""

from . import ops, ref

__all__ = ["ops", "ref"]
