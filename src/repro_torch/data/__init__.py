"""Data pipelines of the matching side: real-matrix ingestion
(``repro_torch.data.mtx``), the paper's weight metrics
(``repro_torch.data.weight_transforms``) and the facade over them and the
synthetic generators (``repro_torch.data.matrices``). Host numpy; a
problem is built on the card unless the caller asks for the CPU. The JAX
package's network downloader has no counterpart: the inputs here are
files on disk, such as the fixtures in ``tests/data/``."""
from repro_torch.data import matrices, mtx, weight_transforms

__all__ = ["matrices", "mtx", "weight_transforms"]
