"""The card's published peaks and the work of the kernels whose roofline
share the benchmark reports.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates), which
assume the card's full 700 W; a run writes the card's power limit beside
its numbers.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def loop_bytes(nnz: int, n: int, rounds) -> tuple[float, float]:
    """Bytes and float32 operations that the AWAC loop (kernel K2) must
    move and do over instances that ran ``rounds`` rounds each: per round
    run, the edges (row, col, val: 12 bytes each), ``row_ptr`` and the
    state (mates and duals: 16 bytes a vertex) read once and three float
    operations an edge for its gain; each instance's final state written
    once. A copy of ``chip_smoke.loop_bytes`` over the real edges."""
    total = float(sum(int(r) for r in rounds))
    read = total * (12 * nnz + 4 * (n + 2) + 16 * (n + 1))
    return read + len(rounds) * 16 * (n + 1), total * 3.0 * nnz


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes at the memory's rate or
    operations at the float32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def mcm_bytes(nnz: int, n: int, phases: int, layers: int,
              calls: int = 1) -> tuple[float, float]:
    """Bytes and operations that MCM must move and do over ``calls``
    calls that ran ``phases`` phases and ``layers`` BFS layers in all,
    whatever the design: each phase's BFS touches every edge's column and
    value once (8 bytes an edge); each layer reads and writes a frontier
    bitmap; each call's matching read and written once (16 bytes a
    vertex); one comparison an edge a phase. A copy of
    ``chip_smoke.mcm_bytes``, summed over calls."""
    words = -(-n // 32)
    return (8.0 * nnz * phases + 8.0 * words * layers
            + 16.0 * (n + 1) * calls, float(nnz) * phases)
