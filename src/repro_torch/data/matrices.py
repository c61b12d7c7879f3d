"""Matrix pipeline for the matching core: generation, real-matrix ingestion,
weight metrics, and 2D distribution. (Generators live in
repro_torch.core.graph, Matrix Market I/O in repro_torch.data.mtx,
transforms in repro_torch.data.weight_transforms; this module is the
data-pipeline facade over them.)"""
from repro_torch.core.graph import (
    SUITE_KINDS,
    generate,
    matrix_suite,
    normalize_rowcol_max,
)
from repro_torch.data.mtx import (
    CooMatrix,
    MatrixMarketError,
    load_problem,
    read_mtx,
    write_mtx,
)
from repro_torch.data.weight_transforms import TRANSFORMS, compose, get_transform
from repro_torch.sparse.partition import partition_coo_2d

__all__ = [
    "SUITE_KINDS",
    "TRANSFORMS",
    "CooMatrix",
    "MatrixMarketError",
    "compose",
    "generate",
    "get_transform",
    "load_problem",
    "matrix_suite",
    "normalize_rowcol_max",
    "partition_coo_2d",
    "read_mtx",
    "write_mtx",
]
