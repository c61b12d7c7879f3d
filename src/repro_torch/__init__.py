"""repro_torch — the PyTorch and CUDA port of the AWPM matching system.

It mirrors the sub-packages of ``repro`` (the JAX reference, which it does
not import): ``core`` holds the engines and the ``solve()`` facade,
``sparse`` the segment and search primitives, ``kernels`` the hand-written
CUDA kernels (the AWAC loop, flash attention, the MoE router's swap
search, EmbeddingBag and the dense cycle-gain tile) with their plain
torch versions, and ``configs``, ``models`` and ``launch`` the serving
paths: the LM, dense and MoE, and bert4rec
(``python -m repro_torch.launch.serve``).
"""
from repro_torch.core import MatchingProblem, MatchResult, SolveOptions, solve

__all__ = ["MatchingProblem", "MatchResult", "SolveOptions", "solve"]
