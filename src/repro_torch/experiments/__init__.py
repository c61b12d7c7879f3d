"""The paper's evaluation (``paper_eval``): AWPM quality per matrix (the
fixtures, out-of-tree ``.mtx`` files such as the paper's SuiteSparse
instances, and the synthetic suite), over the local backends, "auto" and
the process grids, with the LP-dual certificate. Run it with ``python -m
repro_torch.experiments``."""
from repro_torch.experiments import paper_eval
from repro_torch.experiments.paper_eval import (
    DEFAULT_SPEC,
    QUICK_SPEC,
    EvalCase,
    EvalRecord,
    extra_mtx_cases,
    fixture_cases,
    run_eval,
    synthetic_cases,
    write_outputs,
)

__all__ = [
    "DEFAULT_SPEC",
    "QUICK_SPEC",
    "EvalCase",
    "EvalRecord",
    "extra_mtx_cases",
    "fixture_cases",
    "paper_eval",
    "run_eval",
    "synthetic_cases",
    "write_outputs",
]
