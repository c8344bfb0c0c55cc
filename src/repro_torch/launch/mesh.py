"""Production mesh shapes and the H100's data-sheet constants.

Counterpart of ``repro.launch.mesh``.  The reference builds JAX meshes of
host devices.  Here the production shapes are axis names and sizes
(:class:`~repro_torch.distributed.sharding.MeshShape`), which is all the
dry run's cell list, rule resolution and byte counts read;
:func:`make_mesh` builds a mesh of ``torch.distributed`` ranks (a
:class:`~repro_torch.distributed.sharding.Mesh`, which is also a
``MeshShape``) over an initialised process group.  Shapes:

  single-pod:  (16, 16)    -> ("data", "model")        256 devices
  multi-pod :  (2, 16, 16) -> ("pod", "data", "model") 512 devices
  debug     :  (2, 4)      -> ("data", "model")          8 devices
"""

from __future__ import annotations

from ..distributed.sharding import MeshShape, make_mesh

__all__ = ["make_production_mesh", "make_debug_mesh", "make_mesh",
           "PEAK_FLOPS_BF16",
           "PEAK_FLOPS_F32", "HBM_BW", "HBM_PER_DEVICE", "NVLINK_BW"]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(axes, shape)


def make_debug_mesh(n_data: int = 2, n_model: int = 4) -> MeshShape:
    """Small mesh (8 devices) of the reference's distributed tests."""
    return MeshShape(("data", "model"), (n_data, n_model))


# NVIDIA H100 SXM5 80GB constants for the roofline analysis (per card),
# from NVIDIA's H100 Tensor Core GPU data sheet (the SXM column; the same
# figures as ``kernel_bench.PEAKS["SXM"]``).
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bfloat16 dense tensor core
PEAK_FLOPS_F32 = 67e12  # FLOP/s, float32 outside the tensor cores (TF32 off)
HBM_BW = 3.35e12  # B/s, HBM3
HBM_PER_DEVICE = 80e9  # bytes: "80GB" on the data sheet
# NVLink 4: 900 GB/s per GPU in both directions together, 450 GB/s each
# way.  A mesh larger than one 8-GPU node also crosses the network between
# nodes, whose rate the data sheet does not give, so a collective term at
# this rate is a lower bound.
NVLINK_BW = 450e9  # B/s per direction per GPU
