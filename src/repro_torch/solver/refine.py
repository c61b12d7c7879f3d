"""Triangular solves + mixed-precision iterative refinement.

The paper's pipeline commits to static pivots BEFORE factorization, so the
factorization is cheap-but-approximate and **iterative refinement** is
where accuracy is recovered, or visibly lost, which is the experiment:
AWPM-pivoted systems converge in a handful of sweeps, unpivoted
ill-conditioned systems diverge or stall. This module implements that
loop with the precision split real solvers use:

- the L/U factors are demoted to **float32/complex64** and the triangular
  sweeps run as torch on the device (the "fast, low-precision solve"),
- residuals ``r = b - A x`` are computed in **float64/complex128** host
  numpy against the ORIGINAL sparse matrix (the "accurate residual"),
  and corrections accumulate into a float64 iterate.

That split is what makes the refinement trajectory meaningful: a single
f32 solve lands around 1e-6; refinement against the f64 residual walks it
to ~1e-15, unless pivot growth destroyed the factors, in which case the
trajectory visibly stalls or explodes. Per-RHS ``converged`` /
``diverged`` / ``stalled`` flags plus the full residual history are
returned, never just a final number.

Batching: the triangular sweeps are written once over ``[B, n]``
right-hand sides, row by row, each row's inner product a multiply and a
sum; a single RHS is solved as its own B = 1 batch of the SAME sweep. The
sum is a fixed pairwise tree of elementwise adds over the row padded to a
power of two (no reduction kernel, whose order could follow the shape), so
batched and single solves agree bit for bit lane by lane, and a real
system's sweeps give the same bits on the card as on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.single import resolve_device
from repro_torch.solver.lu import CsrMatrix, LUFactorization

__all__ = ["RefineResult", "lu_solve_once", "refine"]


# --------------------------------------------------------------------------
# torch triangular sweeps (the low-precision inner solver)
# --------------------------------------------------------------------------


def _tree_sum(x):
    """Sum over axis 1 (a power of two wide) by halving: the same
    elementwise adds in the same order for every batch size and device."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def _cmul(a, b):
    """Elementwise product of complex numbers held as [..., 2] (re, im)
    float32 pairs, in separate real multiplies and adds: a vectorized
    complex kernel could round a lane differently by its position."""
    ar, ai = a.unbind(-1)
    br, bi = b.unbind(-1)
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def _cdiv(a, b):
    """``a / b`` for [..., 2] pairs (Smith's algorithm, no overflow of
    the squared modulus)."""
    ar, ai = a.unbind(-1)
    br, bi = b.unbind(-1)
    big = br.abs() >= bi.abs()
    r = torch.where(big, bi / br, br / bi)
    den = torch.where(big, br + bi * r, br * r + bi)
    re = torch.where(big, ar + ai * r, ar * r + ai) / den
    im = torch.where(big, ai - ar * r, ai * r - ar) / den
    return torch.stack([re, im], dim=-1)


def _ops(t):
    """(multiply, divide) for the sweep operands: real float32, or
    complex64 as [..., 2] pairs (a factor of three axes)."""
    if t.dim() == 3:
        return _cmul, _cdiv
    return torch.mul, torch.div


def _solve_unit_lower(l_strict, b):
    """x of (I + L_strict) x = b, forward sweep. ``l_strict`` [n, P] and
    ``b`` [B, P], zero beyond column n (P the width padded to a power of
    two); complex operands carry a trailing (re, im) axis."""
    mul, _ = _ops(l_strict)
    x = torch.zeros_like(b)
    for k in range(l_strict.shape[0]):
        x[:, k] = b[:, k] - _tree_sum(mul(l_strict[k], x))
    return x


def _solve_upper(u_strict, u_diag, b):
    """x of (diag(u_diag) + U_strict) x = b, backward sweep, padded as in
    :func:`_solve_unit_lower`."""
    mul, div = _ops(u_strict)
    x = torch.zeros_like(b)
    for k in range(u_strict.shape[0] - 1, -1, -1):
        x[:, k] = div(b[:, k] - _tree_sum(mul(u_strict[k], x)), u_diag[k])
    return x


def _width(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _pairs(x):
    """A complex64 array as float32 (re, im) pairs on a trailing axis; a
    real one unchanged."""
    if np.iscomplexobj(x):
        return np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return x


def _dense_factors(factor: LUFactorization, device):
    """Demote the CSR factors to dense f32/c64 sweep operands once, padded
    to a power-of-two width, on ``device``."""
    complex_in = np.iscomplexobj(factor.U.data)
    dt = np.complex64 if complex_in else np.float32
    n, width = factor.U.n, _width(factor.U.n)
    with np.errstate(over="ignore"):  # growth-blown factors overflow f32
        l_strict = factor.L.to_dense().astype(dt)  # on purpose: the inf
        u_strict = factor.U.to_dense().astype(dt)  # surfaces as divergence
    u_diag = np.diag(u_strict).copy()
    np.fill_diagonal(u_strict, 0)
    pad = ((0, 0), (0, width - n))
    return tuple(torch.from_numpy(_pairs(x)).to(device) for x in (
        np.pad(l_strict, pad), np.pad(u_strict, pad), u_diag))


def _apply_factors(l_strict, u_strict, u_diag, row_perm, b):
    """[B, n] right-hand sides (host) -> the f32/c64 solve, as host numpy
    [B, n] (complex64 for complex factors)."""
    n = u_diag.shape[0]
    complex_in = l_strict.dim() == 3
    dt = np.complex64 if complex_in else np.float32
    pb = np.zeros((b.shape[0], l_strict.shape[1]), dt)
    pb[:, :n] = np.asarray(b)[..., row_perm]
    pb = torch.from_numpy(_pairs(pb)).to(l_strict.device)
    y = _solve_unit_lower(l_strict, pb)
    x = _solve_upper(u_strict, u_diag, y)[:, :n].cpu().numpy()
    return x[..., 0] + 1j * x[..., 1] if complex_in else x


def lu_solve_once(factor: LUFactorization, b: np.ndarray,
                  device=None) -> np.ndarray:
    """One low-precision solve ``x ~ A^-1 b`` through the factors
    (applies the factorization's internal row permutation), the sweeps on
    ``device`` (None: the card). ``b`` is ``[n]`` or ``[B, n]``; the
    single-RHS form is the B=1 lift."""
    l_strict, u_strict, u_diag = _dense_factors(factor,
                                                resolve_device(device))
    b = np.asarray(b)
    single = b.ndim == 1
    bb = b[None, :] if single else b
    x = _apply_factors(l_strict, u_strict, u_diag, factor.row_perm, bb)
    x = np.asarray(x, dtype=np.complex128 if u_strict.dim() == 3
                   else np.float64)
    return x[0] if single else x


# --------------------------------------------------------------------------
# the refinement loop (high-precision residuals, host side)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RefineResult:
    """Outcome of refining a batch of B right-hand sides.

    ``residuals[t, b]`` is lane b's relative residual
    ``||r||_2 / ||rhs||_2`` before iteration t (so ``residuals[0]`` is the
    quality of the raw f32 solve's starting point: all-ones, since x
    starts at 0). Frozen lanes (converged / diverged / stalled) repeat
    their final residual in later rows, keeping the array rectangular.
    """

    x: np.ndarray  # [B, n] float64 / complex128
    residuals: np.ndarray  # [T, B] float64 relative residuals
    iterations: np.ndarray  # [B] int64: sweeps actually applied per lane
    converged: np.ndarray  # [B] bool
    diverged: np.ndarray  # [B] bool
    stalled: np.ndarray  # [B] bool
    tol: float

    @property
    def all_converged(self) -> bool:
        return bool(self.converged.all())

    @property
    def final_residual(self) -> np.ndarray:
        """[B]: each lane's last recorded relative residual."""
        return self.residuals[-1]


def _csr_matvec(a: CsrMatrix, x: np.ndarray) -> np.ndarray:
    """f64/c128 host matvec ``A @ x`` for x: [B, n] (exact residual path,
    deliberately NOT the f32 device path being refined)."""
    out = np.zeros_like(x)
    for i in range(a.n):
        lo, hi = int(a.indptr[i]), int(a.indptr[i + 1])
        # multiply + pairwise sum over the LAST axis only: accumulation
        # order per lane is independent of B (a BLAS `@` here picks
        # shape-dependent kernels and breaks batched/single bit-equality)
        out[:, i] = np.sum(x[:, a.indices[lo:hi]] * a.data[lo:hi], axis=-1)
    return out


def refine(a: CsrMatrix, factor: LUFactorization, b: np.ndarray, *,
           tol: float = 1e-12, max_iter: int = 40,
           stall_window: int = 3, stall_factor: float = 0.5,
           divergence_factor: float = 1e4, device=None) -> RefineResult:
    """Iteratively refine ``A x = b`` through the (possibly perturbed,
    possibly garbage) factors of ``a``, the triangular sweeps on
    ``device`` (None: the card).

    ``b`` is ``[n]`` or ``[B, n]``; a single RHS runs as the B=1 lift of
    the batched path and is squeezed on return. Per lane, iteration stops
    on the first of: **converged** (relative residual <= tol),
    **diverged** (residual non-finite, or > divergence_factor x the best
    seen), **stalled** (no ``stall_factor`` improvement across
    ``stall_window`` consecutive sweeps), or ``max_iter``. Frozen lanes
    stop updating (their x is exactly what it was at freeze time) while
    live lanes continue, so one bad RHS never poisons its batch.
    """
    b = np.asarray(b)
    single = b.ndim == 1
    complex_sys = np.iscomplexobj(a.data) or np.iscomplexobj(b)
    acc = np.complex128 if complex_sys else np.float64
    bb = (b[None, :] if single else b).astype(acc)
    B, n = bb.shape
    if n != a.n:
        raise ValueError(f"rhs width {n} != matrix order {a.n}")

    l_strict, u_strict, u_diag = _dense_factors(factor,
                                                resolve_device(device))
    bnorm = np.linalg.norm(bb, axis=-1)
    bnorm = np.where(bnorm == 0.0, 1.0, bnorm)

    x = np.zeros((B, n), acc)
    live = np.ones(B, bool)
    converged = np.zeros(B, bool)
    diverged = np.zeros(B, bool)
    iterations = np.zeros(B, np.int64)
    best = np.full(B, np.inf)
    since_improve = np.zeros(B, np.int64)
    history = []

    for _ in range(max_iter + 1):
        r = bb - _csr_matvec(a, x)
        rel = np.linalg.norm(r, axis=-1) / bnorm
        # frozen lanes keep their freeze-time residual on the record
        if history:
            rel = np.where(live, rel, history[-1])
        history.append(rel)

        hit = live & (rel <= tol)
        converged |= hit
        live &= ~hit
        blown = live & (~np.isfinite(rel) | (rel > divergence_factor *
                                             np.minimum(best, 1.0)))
        diverged |= blown
        live &= ~blown
        improved = rel < stall_factor * best
        since_improve = np.where(improved, 0, since_improve + 1)
        best = np.minimum(best, np.where(np.isfinite(rel), rel, np.inf))
        stalled_now = live & (since_improve >= stall_window)
        live &= ~stalled_now
        if not live.any():
            break

        # one low-precision correction sweep; frozen lanes masked out so
        # their x (and thus their recorded residual) never moves again
        d = np.asarray(
            _apply_factors(l_strict, u_strict, u_diag, factor.row_perm, r),
            dtype=acc)
        d = np.where(np.isfinite(d), d, 0.0)
        x = x + np.where(live[:, None], d, 0.0)
        iterations += live.astype(np.int64)

    stalled = ~(converged | diverged) & (np.asarray(history[-1]) > tol)
    return RefineResult(
        x=x[0] if single else x,
        residuals=np.asarray(history),
        iterations=iterations,
        converged=converged,
        diverged=diverged,
        stalled=stalled,
        tol=float(tol))
