"""Shared numeric constants of the AWPM algorithm family.

``MIN_GAIN`` is the paper's epsilon: a 4-cycle must improve the matching
weight by more than this to count as an augmenting candidate (guards both
float round-off churn and nontermination on exact ties). Every engine of
this package and the public ``SolveOptions`` default import this one
definition so they can never drift apart.
"""
from __future__ import annotations

MIN_GAIN = 1e-6
