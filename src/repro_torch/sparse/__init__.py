"""Sparse primitives: CSR row pointers, the padded CSR of the data
pipeline, segment/search operations (those of the matching engines and
those of GNN message passing) and the 2D block partition of the grid
engine."""
from repro_torch.sparse.csr import (
    PaddedCSR,
    coo_to_padded_csr,
    dedupe_coo_sum,
    max_row_nnz,
    row_ptr_from_sorted,
    sort_coo,
    window_depth,
)
from repro_torch.sparse.ops import (
    coo_sddmm,
    coo_spmm,
    lex_searchsorted,
    searchsorted_in_window,
    segment_argmax,
    segment_max,
    segment_max_with_payload,
    segment_softmax,
    segment_sum,
)
from repro_torch.sparse.partition import (
    Partition2D,
    Partition2DBatched,
    block_occupancy,
    partition_coo_2d,
    partition_coo_2d_batched,
    plan_block_cap,
)

__all__ = [
    "PaddedCSR",
    "Partition2D",
    "Partition2DBatched",
    "block_occupancy",
    "coo_sddmm",
    "coo_spmm",
    "coo_to_padded_csr",
    "dedupe_coo_sum",
    "lex_searchsorted",
    "max_row_nnz",
    "partition_coo_2d",
    "partition_coo_2d_batched",
    "plan_block_cap",
    "row_ptr_from_sorted",
    "searchsorted_in_window",
    "segment_argmax",
    "segment_max",
    "segment_max_with_payload",
    "segment_softmax",
    "segment_sum",
    "sort_coo",
    "window_depth",
]
