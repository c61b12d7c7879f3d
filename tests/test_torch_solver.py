"""The port's static-pivoting solver (``repro_torch.solver``) against the
JAX package's, on the six Matrix Market fixtures of ``tests/data`` and
the three planted systems of the solver experiments, under the four arms
(awpm, reference, none, tpp).

The JAX side runs once, in one child process, on the same arrays. Held
to it:

  - bit for bit: the pivoting's ``row_perm``, ``dr`` and ``dc``, the
    sparse LU's factors (L, U, row_perm) and every ``LUStats`` field, the
    scaled diagonal's minimum and the matching's weight and tightness;
  - within 1e-5 relative: ``lu_solve_once`` (float32 triangular sweeps,
    summed in another order than JAX's);
  - equal: the refinement's converged / diverged / stalled flags per
    (case, arm).

Then the port on its own: batched and single refinement identical lane by
lane, the two absolute claims of the solver experiments on 9/9 cases,
and the JAX suite's own checks of the LU and the pipeline. Every solve
here runs on the CPU (``device="cpu"``); the card's cases are marked
``gpu``.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.solver as solver  # noqa: E402
from repro_torch.core import ref  # noqa: E402
from repro_torch.core.dual import dual_certificate  # noqa: E402
from repro_torch.core.preflight import PreflightError  # noqa: E402
from repro_torch.data.mtx import read_mtx  # noqa: E402
from repro_torch.data.weight_transforms import log2_scaled  # noqa: E402
from repro_torch.solver import (  # noqa: E402
    CsrMatrix,
    awpm_pivoting,
    identity_pivoting,
    lu_solve_once,
    refine,
    solve_linear_system,
    sparse_lu,
)
from repro_torch.solver import experiments  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
FIXTURES = sorted(p.stem for p in DATA.glob("*.mtx"))
ARMS = experiments.ARMS
CPU = "cpu"


def load(stem):
    coo = read_mtx(DATA / f"{stem}.mtx")
    val = np.asarray(coo.val)
    dtype = np.complex128 if np.iscomplexobj(val) else np.float64
    return (np.asarray(coo.row, np.int64), np.asarray(coo.col, np.int64),
            val.astype(dtype), coo.nrows)


def systems():
    """The nine cases: name -> (row, col, val, n)."""
    out = {stem: load(stem) for stem in FIXTURES}
    for name, _, (row, col, val, n) in experiments.planted_systems():
        out[name] = (np.asarray(row, np.int64), np.asarray(col, np.int64),
                     np.asarray(val, np.float64), n)
    return out


SYSTEMS = systems()
CASES = list(SYSTEMS)


def rhs_for(n, val, seed=7):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n)
    if np.iscomplexobj(val):
        b = b + 1j * rng.standard_normal(n)
    return b


def arm_kwargs(arm):
    return {"pivoting": "none", "lu_mode": "threshold"} if arm == "tpp" \
        else {"pivoting": arm}


def scaled_factor(rep, row, col, val, n, lu_mode):
    """The scaled matrix and the factor ``solve_linear_system`` built."""
    pr, pc, pv = rep.pivot.scaled_coo(row, col, val)
    scaled = CsrMatrix.from_coo(pr, pc, pv, n)
    return scaled, sparse_lu(scaled, mode=lu_mode)


STATS = ("n", "nnz_in", "nnz_l", "nnz_u", "fill_ratio", "pivot_growth",
         "min_pivot", "perturbed_pivots", "swaps")

REFERENCE = """
from repro.solver import CsrMatrix, lu_solve_once, solve_linear_system, sparse_lu

for case in CASES:
    row, col, val = IN[f"{case}__row"], IN[f"{case}__col"], IN[f"{case}__val"]
    n = int(IN[f"{case}__n"])
    b = IN[f"{case}__b"]
    for arm in ARMS:
        kw = ({"pivoting": "none", "lu_mode": "threshold"} if arm == "tpp"
              else {"pivoting": arm})
        rep = solve_linear_system((row, col, val, n), b, **kw)
        k = f"{case}__{arm}__"
        OUT[k + "row_perm"] = rep.pivot.row_perm
        OUT[k + "dr"] = rep.pivot.dr
        OUT[k + "dc"] = rep.pivot.dc
        OUT[k + "diag_min"] = rep.scaled_diag_min
        OUT[k + "weight"] = np.nan if rep.matching_weight is None \\
            else rep.matching_weight
        OUT[k + "tight"] = -1 if rep.matching_tight is None \\
            else int(rep.matching_tight)
        r = rep.refinement
        OUT[k + "flags"] = np.stack([r.converged, r.diverged, r.stalled])
        OUT[k + "ok"] = rep.ok
        for f in STATS:
            OUT[k + "stat_" + f] = getattr(rep.lu_stats, f)
        pr, pc, pv = rep.pivot.scaled_coo(row, col, val)
        scaled = CsrMatrix.from_coo(pr, pc, pv, n)
        factor = sparse_lu(scaled, mode=kw.get("lu_mode", "static"))
        for name in ("L", "U"):
            m = getattr(factor, name)
            OUT[k + name + "_indptr"] = m.indptr
            OUT[k + name + "_indices"] = m.indices
            OUT[k + name + "_data"] = m.data
        OUT[k + "lu_row_perm"] = factor.row_perm
        if arm == "awpm":
            OUT[k + "once"] = lu_solve_once(factor, IN[f"{case}__b3"])
"""


@pytest.fixture(scope="module")
def jax_solver(tmp_path_factory):
    inputs = {}
    for case, (row, col, val, n) in SYSTEMS.items():
        b3 = np.stack([rhs_for(n, val, seed=s) for s in (1, 2, 3)])
        inputs.update({f"{case}__row": row, f"{case}__col": col,
                       f"{case}__val": val, f"{case}__n": np.array(n),
                       f"{case}__b": rhs_for(n, val), f"{case}__b3": b3})
    header = f"CASES = {CASES!r}\nARMS = {ARMS!r}\nSTATS = {STATS!r}\n"
    return run_reference(header + REFERENCE, inputs,
                         tmp_path_factory.mktemp("solver"))


@pytest.fixture(scope="module")
def port_reports():
    out = {}
    for case, (row, col, val, n) in SYSTEMS.items():
        for arm in ARMS:
            out[case, arm] = solve_linear_system(
                (row, col, val, n), rhs_for(n, val), device=CPU,
                **arm_kwargs(arm))
    return out


def _bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("case", CASES)
def test_pivoting_and_factors_equal_jax_bit_for_bit(jax_solver, port_reports,
                                                     case, arm):
    row, col, val, n = SYSTEMS[case]
    rep = port_reports[case, arm]
    k = f"{case}__{arm}__"
    for f in ("row_perm", "dr", "dc"):
        _bits(getattr(rep.pivot, f), jax_solver[k + f], f)
    assert rep.scaled_diag_min == float(jax_solver[k + "diag_min"])
    if rep.matching_weight is None:
        assert np.isnan(jax_solver[k + "weight"])
        assert int(jax_solver[k + "tight"]) == -1
    else:
        assert rep.matching_weight == float(jax_solver[k + "weight"])
        assert int(rep.matching_tight) == int(jax_solver[k + "tight"])
    for f in STATS:
        assert getattr(rep.lu_stats, f) == jax_solver[k + "stat_" + f], f
    _, factor = scaled_factor(rep, row, col, val, n,
                              arm_kwargs(arm).get("lu_mode", "static"))
    for name in ("L", "U"):
        m = getattr(factor, name)
        for part in ("indptr", "indices", "data"):
            _bits(getattr(m, part), jax_solver[f"{k}{name}_{part}"],
                  f"{name}.{part}")
    _bits(factor.row_perm, jax_solver[k + "lu_row_perm"], "lu row_perm")


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("case", CASES)
def test_refinement_flags_equal_jax(jax_solver, port_reports, case, arm):
    rep = port_reports[case, arm]
    r = rep.refinement
    k = f"{case}__{arm}__"
    np.testing.assert_array_equal(
        np.stack([r.converged, r.diverged, r.stalled]), jax_solver[k + "flags"])
    assert rep.ok == bool(jax_solver[k + "ok"])


@pytest.mark.parametrize("case", CASES)
def test_lu_solve_once_within_1e5_of_jax(jax_solver, port_reports, case):
    row, col, val, n = SYSTEMS[case]
    _, factor = scaled_factor(port_reports[case, "awpm"], row, col, val, n,
                              "static")
    b3 = np.stack([rhs_for(n, val, seed=s) for s in (1, 2, 3)])
    got = lu_solve_once(factor, b3, device=CPU)
    want = jax_solver[f"{case}__awpm__once"]
    assert got.dtype == want.dtype
    scale = np.linalg.norm(want, axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * scale).all()
    # the single RHS is the B = 1 lift, bit for bit
    assert lu_solve_once(factor, b3[1], device=CPU).tobytes() == \
        got[1].tobytes()


# --------------------------------------------------------------------------
# the port on its own
# --------------------------------------------------------------------------


def test_the_two_absolute_claims_hold_on_9_of_9_cases():
    rows, failures = experiments.run(device=CPU, log=lambda *a: None)
    assert failures == []
    awpm = [r for r in rows if r.arm == "awpm"]
    assert len(awpm) == 9
    assert all(r.converged and r.residual <= 1e-10 for r in awpm)
    assert experiments.contrast_cases(rows)  # none fails, awpm converges
    assert all(r.k2_launches == 0 for r in rows)  # the CPU runs no kernel


def test_check_claims_reports_each_failure():
    rows, _ = experiments.run(device=CPU, quick=True, log=lambda *a: None)
    bad = [experiments.SolverRow(**{**r.__dict__, "residual": 1e-6})
           if r.arm == "awpm" and r.case == "circuit8" else r for r in rows]
    assert any("circuit8 [awpm]: residual" in f
               for f in experiments.check_claims(bad))
    calm = [experiments.SolverRow(**{**r.__dict__, "converged": True})
            for r in rows]
    assert any("contrast" in f for f in experiments.check_claims(calm))
    assert experiments.check_claims([]) == ["solver: no rows"]


@pytest.mark.parametrize("batch", [2, 5])
@pytest.mark.parametrize("case", ["illcond9", "zcoil7", "planted_illcond64"])
def test_batched_refinement_bit_identical_to_single(case, batch):
    row, col, val, n = SYSTEMS[case]
    a = CsrMatrix.from_coo(row, col, val, n)
    factor = sparse_lu(a, mode="threshold")
    bs = np.stack([rhs_for(n, val, seed=s) for s in range(batch)])
    many = refine(a, factor, bs, device=CPU)
    for i in range(batch):
        one = refine(a, factor, bs[i], device=CPU)
        assert one.x.tobytes() == many.x[i].tobytes()
        assert one.residuals[:, 0].tobytes() == \
            many.residuals[:one.residuals.shape[0], i].tobytes()
        assert one.iterations[0] == many.iterations[i]


def test_refine_freezes_lanes_independently():
    row, col, val, n = SYSTEMS["illcond9"]
    a = CsrMatrix.from_coo(row, col, val, n)
    factor = sparse_lu(a, mode="static")  # unpivoted: diverges
    bs = np.stack([rhs_for(n, val, seed=s) for s in range(3)])
    r = refine(a, factor, bs, device=CPU)
    assert r.residuals.shape[1] == 3
    assert not r.converged.any()
    # a frozen lane's residual repeats after it froze
    last = r.iterations.max()
    for i in range(3):
        t = int(r.iterations[i])
        assert (r.residuals[t + 1:, i] == r.residuals[t, i]).all() \
            or t == last


@pytest.mark.parametrize("stem", FIXTURES)
def test_threshold_lu_reconstructs_fixture(stem):
    row, col, val, n = load(stem)
    a = CsrMatrix.from_coo(row, col, val, n)
    f = sparse_lu(a, mode="threshold", threshold=1.0)
    L = f.L.to_dense() + np.eye(n)
    pa = a.to_dense()[f.row_perm]
    assert np.allclose(L @ f.U.to_dense(), pa, atol=1e-10 * abs(pa).max())


def test_gesp_floor_on_missing_diagonal():
    a = CsrMatrix.from_coo([0, 1], [1, 0], [2.0, 3.0], 2)
    f = sparse_lu(a, mode="static")
    assert f.stats.perturbed_pivots >= 1
    floor = float(np.sqrt(np.finfo(np.float32).eps)) * 3.0
    assert f.stats.min_pivot == pytest.approx(floor)


def test_sparse_lu_rejects_bad_inputs():
    a = CsrMatrix.from_coo([0, 1], [0, 1], [1.0, 1.0], 2)
    with pytest.raises(ValueError, match="mode"):
        sparse_lu(a, mode="full")
    with pytest.raises(ValueError, match="threshold"):
        sparse_lu(a, mode="threshold", threshold=0.0)
    with pytest.raises(ValueError, match="structurally singular"):
        sparse_lu(CsrMatrix.from_coo([0, 1], [0, 0], [1.0, 1.0], 2),
                  mode="threshold")
    with pytest.raises(ValueError, match="all-zero"):
        sparse_lu(CsrMatrix.from_coo([], [], [], 2))


def test_structural_singularity_raises_preflight():
    row, col, val = np.array([0, 1, 2]), np.array([0, 1, 0]), \
        np.array([1.0, 2.0, 3.0])
    with pytest.raises(PreflightError):
        solve_linear_system((row, col, val, 3), np.ones(3), device=CPU)
    with pytest.raises(PreflightError):
        solve_linear_system((row, col, val, 3), np.ones(3),
                            pivoting="awpm", check=False, device=CPU)


def test_solve_rejects_bad_arguments():
    row, col, val, n = load("bands6_sym")
    with pytest.raises(ValueError, match="pivoting"):
        solve_linear_system((row, col, val, n), np.ones(n),
                            pivoting="partial", device=CPU)
    with pytest.raises(ValueError, match="width"):
        solve_linear_system((row, col, val, n), np.ones(n + 1), device=CPU)
    with pytest.raises(ValueError, match="square"):
        solve_linear_system(np.ones((2, 3)), np.ones(3), device=CPU)


def test_input_forms_agree_bitwise():
    row, col, val, n = load("circuit8")
    b = rhs_for(n, val)
    dense = np.zeros((n, n))
    dense[row, col] = val
    reps = [solve_linear_system(a, b, device=CPU) for a in (
        (row, col, val, n), dense, CsrMatrix.from_coo(row, col, val, n))]
    for rep in reps[1:]:
        assert rep.x.tobytes() == reps[0].x.tobytes()


def test_potentials_accessor_is_feasible_and_copied():
    row, col, val, n = load("circuit8")
    w = log2_scaled(row, col, np.abs(val), n)
    _, result = awpm_pivoting(row, col, val, n, device=CPU)
    mate = result.mate_row.numpy()[:n]
    cert = dual_certificate(row, col, w, n, mate)
    u, v = cert.potentials()
    slack = u[row] + v[col] - w
    assert float(slack.min()) >= -1e-9
    assert cert.tight
    u[:] = -1e9
    assert float(cert.potentials()[0].min()) > -1e9


def test_identity_pivoting_and_timings():
    p = identity_pivoting(4)
    b = np.arange(4.0)
    assert np.array_equal(p.scale_rhs(b), b)
    assert np.array_equal(p.unscale_solution(b), b)
    with pytest.raises(ValueError, match="permutation"):
        solver.ScaledPivoting(n=2, row_perm=np.array([0, 0]),
                              dr=np.ones(2), dc=np.ones(2))
    row, col, val, n = load("illcond9")
    rep = solve_linear_system((row, col, val, n), rhs_for(n, val),
                              device=CPU)
    assert set(rep.split) == {"matching_s", "lu_s", "refine_s"}
    assert all(t >= 0 for t in rep.split.values())


def test_solver_export_surface_and_reference_arm():
    assert sorted(solver.__all__) == sorted([
        "CsrMatrix", "LUFactorization", "LUStats", "PIVOTING_MODES",
        "RefineResult", "ScaledPivoting", "SolveReport", "awpm_pivoting",
        "from_matching", "identity_pivoting", "lu_solve_once",
        "reference_pivoting", "refine", "solve_linear_system", "sparse_lu"])
    assert ref.HAVE_SCIPY
    row, col, val, n = load("circuit8")
    a, _ = awpm_pivoting(row, col, val, n, device=CPU)
    r, _ = solver.reference_pivoting(row, col, val, n)
    assert np.array_equal(a.row_perm, r.row_perm)


def test_solver_defaults_to_the_card():
    row, col, val, n = load("circuit8")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_linear_system((row, col, val, n), np.ones(n))


def test_experiments_cli_on_the_cpu(tmp_path):
    import json
    import os
    import subprocess
    import sys

    out = tmp_path / "rows.json"
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).parents[1]
                                          / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.solver.experiments", "--device",
         "cpu", "--quick", "--out", str(out)], capture_output=True,
        text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "awpm converged to <= 1e-10 on 6/6" in proc.stdout
    assert len(json.loads(out.read_text())) == 24


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_card_solves_equal_the_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the awpm arm's matching runs the "
                    "persistent AWAC kernel (CUDA C++ for sm_90a)")
    from repro_torch.kernels import backend

    row, col, val, n = SYSTEMS[case]
    b = rhs_for(n, val)
    backend.reset_launch_counts()
    card = solve_linear_system((row, col, val, n), b)
    assert backend.launch_counts()["awac_persistent"] >= 1
    cpu = solve_linear_system((row, col, val, n), b, device=CPU)
    assert np.array_equal(card.pivot.row_perm, cpu.pivot.row_perm)
    assert card.pivot.dr.tobytes() == cpu.pivot.dr.tobytes()
    assert card.ok and card.residual.max() <= 1e-10
    if not np.iscomplexobj(val):  # real sweeps: the same bits on both
        assert card.x.tobytes() == cpu.x.tobytes()
