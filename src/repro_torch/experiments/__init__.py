"""The paper's evaluation (``paper_eval``): AWPM quality per matrix, over
the local backends, "auto" and the process grids, with the LP-dual
certificate. Run it with ``python -m repro_torch.experiments``."""
from repro_torch.experiments import paper_eval

__all__ = ["paper_eval"]
