"""Hand-written CUDA kernels (sources under ``csrc/``) with their plain
torch versions, and the build/launch bookkeeping in ``backend``."""
from repro_torch.kernels.backend import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
