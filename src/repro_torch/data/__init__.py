"""Data pipelines of the matching side: real-matrix ingestion
(``repro_torch.data.mtx``), the paper's weight metrics
(``repro_torch.data.weight_transforms``), the facade over them and the
synthetic generators (``repro_torch.data.matrices``) and the opt-in
SuiteSparse downloader (``repro_torch.data.suitesparse``, which the
evaluation runner's ``--download`` calls; a filled cache needs no
network). Host numpy; a problem is built on the card unless the caller
asks for the CPU. The model side's streams are ``repro_torch.data.tokens``
(LM tokens) and ``repro_torch.data.graphs`` (synthetic graphs of the GNN
cells)."""
from repro_torch.data import matrices, mtx, suitesparse, weight_transforms

__all__ = ["matrices", "mtx", "suitesparse", "weight_transforms"]
