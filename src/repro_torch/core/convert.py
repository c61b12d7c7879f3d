"""Carry problems, states and results across the numpy boundary.

Arrays that another implementation produced (saved as numpy) become the
port's tensors here, and the port's results become numpy arrays, so a
test can hand a state from one engine to the other and compare results
field by field. Dtypes and layouts are those of the public functions:
int32 edges and mates, float32 weights and duals, ``[n + 1]`` (or
``[B, n + 1]``) state with sentinel ``n``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import MatchingProblem, MatchResult, resolve_device
from repro_torch.core.single import MatchState


def _tensor(x, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)


def problem_from_numpy(row, col, val, n: int, device=None) -> MatchingProblem:
    """A problem from padded lex-sorted COO arrays ([cap] or [B, cap]),
    taken as they are."""
    dev = resolve_device(device)
    return MatchingProblem(row=_tensor(row, np.int32, dev),
                           col=_tensor(col, np.int32, dev),
                           val=_tensor(val, np.float32, dev), n=int(n))


def state_from_numpy(mate_row, mate_col, u, v, device=None) -> MatchState:
    """A matching state ([n + 1] or [B, n + 1] fields)."""
    dev = resolve_device(device)
    return MatchState(_tensor(mate_row, np.int32, dev),
                      _tensor(mate_col, np.int32, dev),
                      _tensor(u, np.float32, dev),
                      _tensor(v, np.float32, dev))


def result_to_numpy(result: MatchResult) -> dict[str, np.ndarray]:
    """The array fields of a result: mate_row, mate_col, weight,
    awac_iters, perfect."""
    names = ("mate_row", "mate_col", "weight", "awac_iters", "perfect")
    return {name: torch.as_tensor(getattr(result, name)).cpu().numpy()
            for name in names}
