"""Fill-in / pivot-growth / refinement experiments for the static-pivoting
solver: the end-to-end "does the matching replace numerical pivoting?"
measurement the paper motivates AWPM with.

Every Matrix Market fixture of the checkout (``tests/data/*.mtx``) and
three planted synthetic systems are solved
through ``repro_torch.solver.solve_linear_system`` under four arms:

- **awpm**      AWPM matching -> static pivots + MC64 scalings (the
  paper's pipeline), the matching through ``solve()`` on the device;
- **reference** exact MC64-style matching (scipy Hungarian oracle),
  same scalings: isolates matching quality (skipped without scipy);
- **none**      no permutation, no scaling, static LU: the contrast arm
  that is ALLOWED to fail; its divergence on the ill-conditioned cases
  IS the reproduced result;
- **tpp**       no matching, classical threshold partial pivoting: what
  a solver must do at factor time when nothing was done at match time.

Per (case, arm) row: fill ratio, pivot growth, perturbed pivots, scaled
diagonal min, refinement sweeps, the true float64 relative residual,
convergence, the seconds of the matching, the factorization and the
refinement, and the persistent AWAC kernel's launches. The run then holds
the two absolute claims of the solver experiments (:func:`check_claims`):
every awpm row (and every reference row) converges to a residual of at
most 1e-10, and at least one case fails unpivoted where awpm converges.
It exits non-zero when either fails.

    PYTHONPATH=src python -m repro_torch.solver.experiments [--device cpu]
        [--quick] [--out FILE.json]

``--quick`` sweeps the fixtures only. Without ``--device`` the matching
and the triangular sweeps run on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[3]
FIXTURE_DIR = ROOT / "tests" / "data"
ARMS = ("awpm", "reference", "none", "tpp")
MAX_RESIDUAL = 1e-10


@dataclasses.dataclass(frozen=True)
class SolverRow:
    """One (case, arm) measurement."""

    case: str
    source: str  # "fixture" | "planted"
    arm: str
    n: int
    nnz: int
    fill: float
    growth: float
    perturbed: int
    diag_min: float
    sweeps: int
    residual: float
    converged: bool
    wall_s: float
    matching_s: float
    lu_s: float
    refine_s: float
    k2_launches: int  # persistent AWAC kernel launches (0 on the CPU)


def fixture_systems():
    from repro_torch.data.mtx import read_mtx

    for path in sorted(FIXTURE_DIR.glob("*.mtx")):
        coo = read_mtx(path)
        yield path.stem, "fixture", (coo.row, coo.col, coo.val, coo.nrows)


def planted_illcond(n: int, seed: int):
    """The ill-conditioned planted system of order ``n``: a near-zero
    diagonal under a heavy cyclic band, as (name, source, (row, col, val,
    n))."""
    rng = np.random.default_rng(seed)
    row, col, val = [], [], []
    for i in range(n):
        row += [i, i, i]
        col += [i, (i + 1) % n, (i + 3) % n]
        val += [1e-8 * (1.0 + rng.random()), 5.0 + 5.0 * rng.random(),
                0.01 + 0.09 * rng.random()]
    return (f"planted_illcond{n}", "planted",
            (np.array(row), np.array(col), np.array(val), n))


def planted_systems():
    """Parameterized synthetic systems extending the fixture story to
    larger n: the ill-conditioned family (near-zero diagonal under a
    heavy cyclic band: unpivoted growth compounds every step) and a
    diagonally dominant control where even the none arm should succeed."""
    for n, seed in ((32, 1), (64, 2)):
        yield planted_illcond(n, seed)
    n, rng = 48, np.random.default_rng(3)
    row, col, val = [], [], []
    for i in range(n):
        row.append(i)
        col.append(i)
        val.append(10.0 + 10.0 * rng.random())
        for j in rng.choice(n, size=3, replace=False):
            if j != i:
                row.append(i)
                col.append(int(j))
                val.append(float(rng.standard_normal()))
    yield (f"planted_dominant{n}", "planted",
           (np.array(row), np.array(col), np.array(val), n))


def run_case(name, source, system, arms=ARMS, rhs_seed=7, device=None,
             log=print):
    """Solve one system under every arm. Returns a list of
    :class:`SolverRow`."""
    from repro_torch.core import ref
    from repro_torch.kernels import backend
    from repro_torch.solver import solve_linear_system

    row, col, val, n = system
    rng = np.random.default_rng(rhs_seed)
    b = rng.standard_normal(n)
    if np.iscomplexobj(val):
        b = b + 1j * rng.standard_normal(n)
    rows = []
    for arm in arms:
        if arm == "reference" and not ref.HAVE_SCIPY:
            log(f"# {name}: reference arm skipped (no scipy)")
            continue
        kw = {"pivoting": "none", "lu_mode": "threshold"} if arm == "tpp" \
            else {"pivoting": arm}
        before = backend.launch_counts()["awac_persistent"]
        t0 = time.perf_counter()
        rep = solve_linear_system((row, col, val, n), b, device=device, **kw)
        wall = time.perf_counter() - t0
        s = rep.lu_stats
        rows.append(SolverRow(
            case=name, source=source, arm=arm, n=s.n, nnz=s.nnz_in,
            fill=s.fill_ratio, growth=s.pivot_growth,
            perturbed=s.perturbed_pivots,
            diag_min=rep.scaled_diag_min,
            sweeps=int(np.max(rep.refinement.iterations)),
            residual=float(np.max(rep.residual)),
            converged=bool(rep.ok), wall_s=wall,
            k2_launches=backend.launch_counts()["awac_persistent"] - before,
            **rep.split))
        log(f"  {name:<22} {arm:<9} {rep.summary()}")
    return rows


def check_claims(rows, max_residual: float = MAX_RESIDUAL) -> list[str]:
    """The solver experiments' absolute claims over ``rows``:

    1. every ``awpm`` row (and every ``reference`` row present) converged
       with a true relative residual <= ``max_residual``;
    2. at least one case shows the contrast: its ``none`` arm failed
       while its ``awpm`` arm converged.

    Returns the failures (empty: both hold)."""
    failures = []
    by_case: dict[str, dict[str, SolverRow]] = {}
    for r in rows:
        by_case.setdefault(r.case, {})[r.arm] = r
    if not by_case:
        return ["solver: no rows"]
    for case in sorted(by_case):
        for arm in ("awpm", "reference"):
            r = by_case[case].get(arm)
            if r is None:
                if arm == "awpm":
                    failures.append(f"solver {case}: awpm row is missing")
                continue  # reference is optional (no scipy)
            if not r.converged:
                failures.append(f"solver {case} [{arm}]: did not converge "
                                f"(residual {r.residual:.3e})")
            elif not r.residual <= max_residual:
                failures.append(
                    f"solver {case} [{arm}]: residual {r.residual:.3e} over "
                    f"the {max_residual:g} ceiling")
    contrast = contrast_cases(rows)
    if not contrast:
        failures.append(
            "solver: no case shows the none-fails/awpm-converges contrast; "
            "the experiment no longer demonstrates that matching-based "
            "static pivoting replaces numerical pivoting")
    return failures


def contrast_cases(rows) -> list[str]:
    """Cases whose none arm failed while their awpm arm converged."""
    return sorted(
        {r.case for r in rows if r.arm == "none" and not r.converged}
        & {r.case for r in rows if r.arm == "awpm" and r.converged})


def run(device=None, quick: bool = False, log=print):
    """Every case under every arm. Returns (rows, failures of
    :func:`check_claims`)."""
    systems = list(fixture_systems())
    if not quick:
        systems += list(planted_systems())
    rows = []
    for name, source, system in systems:
        rows += run_case(name, source, system, device=device, log=log)
    return rows, check_claims(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="static-pivoting solver experiments")
    ap.add_argument("--device", default=None,
                    help="device of the matching and the sweeps "
                         "(default: the card)")
    ap.add_argument("--quick", action="store_true",
                    help="the fixtures only (planted cases skipped)")
    ap.add_argument("--out", default=None,
                    help="also write the rows as JSON to this file")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    rows, failures = run(device=args.device, quick=args.quick)
    wall = time.perf_counter() - t0
    n_awpm = sum(1 for r in rows if r.arm == "awpm")
    n_conv = sum(1 for r in rows if r.arm == "awpm" and r.converged
                 and r.residual <= MAX_RESIDUAL)
    print(f"# {len(rows)} rows in {wall:.1f}s: awpm converged to <= "
          f"{MAX_RESIDUAL:g} on {n_conv}/{n_awpm}; none-fails/awpm-converges "
          f"contrast on {contrast_cases(rows) or 'NO CASE'}")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            [dataclasses.asdict(r) for r in rows], indent=1))
    for f in failures:
        print(f"# FAILED: {f}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
