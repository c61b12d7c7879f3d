"""Composable edge-weight transforms.

The paper measures pivot quality in the MC64 log-scaled metric: MC64
minimizes the cost ``c_ij = log2(max_i |a_ij|) - log2(|a_ij|)`` (column max
over rows i), which is the same problem as maximizing
``w_ij = log2(|a_ij|) - log2(max_i |a_ij|)`` — the metric
:func:`log2_scaled` produces. Our engine maximizes, so that (non-positive)
weight plugs straight into ``solve()``; :func:`log2_scaled_nonneg` adds one
global constant so weights land in ``[0, shift]``, which changes NOTHING
the algorithm decides: every perfect matching has exactly n edges, so a
constant per-edge shift moves all perfect-matching weights by the same
``n * shift`` (ranking preserved), and every 4-cycle gain
``w1 + w2 - u - v`` is shift-invariant outright.

Every transform has the uniform signature ``(row, col, val, n) -> val`` on
host numpy arrays (float64 out), so they compose (:func:`compose`) and
thread through ``repro_torch.data.mtx.load_problem(transform=...)`` by name.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import normalize_rowcol_max

__all__ = [
    "TRANSFORMS",
    "abs_value",
    "compose",
    "get_transform",
    "log2_scaled",
    "log2_scaled_nonneg",
    "mc64_cost",
    "rowcol_normalized",
]


def _colmax_abs(col, val, n):
    a = np.abs(np.asarray(val, np.float64))
    if (a == 0.0).any():
        raise ValueError(
            "log-scaled transform is undefined on zero entries — explicit "
            "zeros are non-edges (load_problem drops them by default)")
    cmax = np.zeros(n, np.float64)
    np.maximum.at(cmax, col, a)
    return a, cmax


def abs_value(row, col, val, n):
    """|a_ij| — the weight the synthetic suite uses pre-normalization."""
    return np.abs(np.asarray(val, np.float64))


def rowcol_normalized(row, col, val, n):
    """Paper §6.1 normalization: each row/column max is 1, entries <= 1."""
    return normalize_rowcol_max(np.asarray(row), np.asarray(col),
                                np.asarray(val)).astype(np.float64)


def log2_scaled(row, col, val, n):
    """``w_ij = log2|a_ij| - log2(max_i |a_ij|)`` (<= 0, column max = 0).

    Maximizing the sum of these weights over perfect matchings IS
    minimizing the MC64 cost :func:`mc64_cost` — the paper's quality
    metric for pivot selection."""
    a, cmax = _colmax_abs(col, val, n)
    return np.log2(a) - np.log2(cmax[col])


def log2_scaled_nonneg(row, col, val, n):
    """:func:`log2_scaled` lifted by one global constant into ``[0, shift]``.

    Decision-invariant (see module docstring), but keeps all weights
    non-negative so reported matching weights read naturally."""
    w = log2_scaled(row, col, val, n)
    return w - w.min() if w.size else w


def mc64_cost(row, col, val, n):
    """The MC64 minimization cost ``c_ij = log2(max_i|a_ij|) - log2|a_ij|``
    (>= 0). Exposed for reporting — feed :func:`log2_scaled` (its negation)
    to the maximizing engine instead."""
    return -log2_scaled(row, col, val, n)


TRANSFORMS = {
    "abs": abs_value,
    "rowcol": rowcol_normalized,
    "log2_scaled": log2_scaled,
    "log2_scaled_nonneg": log2_scaled_nonneg,
    "mc64_cost": mc64_cost,
}


def compose(*specs):
    """Left-to-right composition: ``compose("abs", "rowcol")`` applies abs
    first, then rowcol normalization. Each spec is a name or a callable."""
    fns = [get_transform(s) for s in specs]

    def composed(row, col, val, n):
        for fn in fns:
            val = fn(row, col, val, n)
        return val

    return composed


def get_transform(spec):
    """Resolve a transform spec: a callable passes through, a str looks up
    :data:`TRANSFORMS`, a sequence composes left-to-right."""
    if callable(spec):
        return spec
    if isinstance(spec, str):
        if spec not in TRANSFORMS:
            raise KeyError(f"unknown weight transform {spec!r}: expected "
                           f"one of {sorted(TRANSFORMS)} or a callable")
        return TRANSFORMS[spec]
    if isinstance(spec, (list, tuple)):
        return compose(*spec)
    raise TypeError(f"weight transform must be a name, callable, or "
                    f"sequence, got {type(spec).__name__}")
