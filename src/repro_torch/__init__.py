"""PyTorch/CUDA port of the asynchronous fixed-point engine.

A second package beside the JAX reference (``repro``), mirroring its
layout: ``core`` (fixed-point interface, Anderson, engine), ``chaos``
(fault scenarios, trace replay), ``recover`` (checkpoints), ``problems``
(Jacobi, value iteration, Hartree–Fock SCF), ``configs``/``models``/
``launch`` (the dense LM decoders and their serving path) and ``kernels`` (hand-written CUDA
kernels for Hopper, ``csrc/``, with their plain PyTorch versions).  It
imports neither JAX nor the reference package.

Entry points run on the card: :func:`default_device` is ``cuda:0``, a
problem built without ``device=`` lands there, and without CUDA they raise
unless the caller passes ``device="cpu"``.  The fixed-point math is
float64; the LM stack is float32 (bfloat16 in the attention kernel too).
"""

from ._device import default_device, has_cuda
from .core import (
    AndersonConfig,
    CoordinatorCrash,
    FaultProfile,
    RunConfig,
    RunResult,
    run_fixed_point,
)
from .problems import (
    GarnetMDP,
    GridWorldMDP,
    JacobiProblem,
    PolicyEvaluationProblem,
    PPPChain,
    SCFProblem,
    UHFPPP,
    UHFSCFProblem,
    ValueIterationProblem,
)

__all__ = [
    "default_device",
    "has_cuda",
    "run_fixed_point",
    "RunConfig",
    "RunResult",
    "FaultProfile",
    "AndersonConfig",
    "CoordinatorCrash",
    "JacobiProblem",
    "GarnetMDP",
    "GridWorldMDP",
    "PolicyEvaluationProblem",
    "ValueIterationProblem",
    "PPPChain",
    "UHFPPP",
    "SCFProblem",
    "UHFSCFProblem",
]
