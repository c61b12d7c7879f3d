"""Sparse primitives: CSR row pointers, the padded CSR of the data
pipeline, and segment/search operations (those of the matching engines
and those of GNN message passing)."""
from repro_torch.sparse.csr import (
    PaddedCSR,
    coo_to_padded_csr,
    dedupe_coo_sum,
    sort_coo,
)
from repro_torch.sparse.ops import (
    coo_sddmm,
    coo_spmm,
    segment_argmax,
    segment_max,
    segment_max_with_payload,
    segment_softmax,
    segment_sum,
)

__all__ = [
    "PaddedCSR",
    "coo_sddmm",
    "coo_spmm",
    "coo_to_padded_csr",
    "dedupe_coo_sum",
    "segment_argmax",
    "segment_max",
    "segment_max_with_payload",
    "segment_softmax",
    "segment_sum",
    "sort_coo",
]
