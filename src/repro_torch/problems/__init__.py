"""The paper's fixed-point testbeds in PyTorch (float64 on the problem's
device).

- :mod:`repro_torch.problems.jacobi`          — 2-D Laplacian block Jacobi
  (§3.3.1)
- :mod:`repro_torch.problems.value_iteration` — Garnet MDP Bellman / policy
  evaluation (§3.3.2)
- :mod:`repro_torch.problems.scf`             — PPP Hartree–Fock SCF, RHF and
  UHF (§3.3.3)

Every tensor is created with an explicit ``dtype``; torch's global default
dtype is left alone.
"""

from .jacobi import JacobiProblem
from .scf import PPPChain, SCFProblem, UHFPPP, UHFSCFProblem
from .value_iteration import (
    GarnetMDP,
    GridWorldMDP,
    PolicyEvaluationProblem,
    ValueIterationProblem,
)

__all__ = [
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
