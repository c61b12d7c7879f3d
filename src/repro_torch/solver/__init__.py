"""``repro_torch.solver``: the end-to-end static-pivoting sparse direct
solver. AWPM matching as pivot order (``solve()`` on the card unless the
caller asks for the CPU), MC64-style scalings from dual potentials,
dependency-light sparse LU on the host (static or threshold pivoting,
GESP perturbation), and mixed-precision iterative refinement (float32
triangular sweeps on the device, float64 residuals on the host). Public
entry point: :func:`solve_linear_system`; ``python -m
repro_torch.solver.experiments`` runs the fill and refinement experiments.
"""
from repro_torch.solver.lu import CsrMatrix, LUFactorization, LUStats, sparse_lu
from repro_torch.solver.pipeline import (
    PIVOTING_MODES,
    SolveReport,
    solve_linear_system,
)
from repro_torch.solver.pivoting import (
    ScaledPivoting,
    awpm_pivoting,
    from_matching,
    identity_pivoting,
    reference_pivoting,
)
from repro_torch.solver.refine import RefineResult, lu_solve_once, refine

__all__ = [
    "CsrMatrix",
    "LUFactorization",
    "LUStats",
    "PIVOTING_MODES",
    "RefineResult",
    "ScaledPivoting",
    "SolveReport",
    "awpm_pivoting",
    "from_matching",
    "identity_pivoting",
    "lu_solve_once",
    "refine",
    "reference_pivoting",
    "solve_linear_system",
    "sparse_lu",
]
