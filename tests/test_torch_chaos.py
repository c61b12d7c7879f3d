"""The port's chaos harness (``repro_torch.runtime.chaos``): its injector
mechanics against the JAX package's, and the detect-vs-survive matrix on
gloo grids of spawned CPU ranks (``tests/_torch_grid.py``).

One JAX child, on 8 fake devices, runs JAX's ``run_chaos_matrix(2, 4)``
and ``_pick_instance`` and applies its exchange taps to fixed buffers;
it runs in a thread beside the port's own spawns. Held to it:

  - the exchange taps' outputs and ``_selected``'s picks, bit for bit;
  - the planted instance and its reference result;
  - the 2x4 matrix over 8 gloo ranks: every record ok on every rank, and
    the same (fault, mode) list as JAX's, ``device_loss_partial`` served
    on the shrunk 1x4 grid by the ranks of its surviving row.

The 2x2 matrix and the 1x1 one run too. Each spawned grid has its own
time limit, so a hung collective fails its test instead of the suite.
"""
import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_grid import run_grid  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MatchingProblem,
    PreflightError,
    SolveOptions,
    batch,
    dist,
    graph,
    single,
    solve,
)
from repro_torch.runtime import chaos  # noqa: E402
from repro_torch.runtime.resilient import (  # noqa: E402
    ResilientOptions,
    TransientFault,
    VerificationError,
    resilient_solve,
)
from test_torch_harness import (  # noqa: E402
    run_reference,
    same_dispatch_as_jax,
)


@pytest.fixture(scope="module", autouse=True)
def _same_dispatch_as_jax(tmp_path_factory):
    """"auto" resolves from the counterpart of JAX's committed dispatch
    table, so the chain starts where JAX's does (``same_dispatch_as_jax``)."""
    with same_dispatch_as_jax(tmp_path_factory.mktemp("dispatch")):
        yield


REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
#: seconds each spawned grid may take before its test fails
GRID_TIMEOUT_S = {(2, 2): 240, (2, 4): 420}

REFERENCE = """
import json
import jax.numpy as jnp
from repro.runtime import chaos

recs = chaos.run_chaos_matrix(2, 4, n=48, log=lambda *a: None)
OUT["records"] = np.array(json.dumps(recs))
for n, deg, k in ((48, 6.0, 3), (32, 5.0, 1)):
    p, r = chaos._pick_instance(n, deg, min_awac_iters=k)
    for f in ("row", "col", "val"):
        OUT[f"pick{n}__{f}"] = np.asarray(getattr(p, f))
    OUT[f"pick{n}__mate_row"] = np.asarray(r.mate_row)
    OUT[f"pick{n}__iters"] = np.asarray(r.awac_iters)
valid = jnp.asarray(IN["valid"])
for seed in (0, 7, 8):
    OUT[f"selected{seed}"] = chaos._selected(valid, seed=seed, count=3)
outs = [jnp.asarray(IN["out_i"]), jnp.asarray(IN["out_j"]),
        jnp.asarray(IN["out_w"])]
for kind in chaos.EXCHANGE_FAULTS:
    tap = chaos._exchange_tap(chaos.FaultSpec(kind, stage=1, seed=7,
                                              count=2))
    o, v = tap("model", outs, valid)
    for name, x in zip(("i", "j", "w"), o):
        OUT[f"tap_{kind}__{name}"] = x
    OUT[f"tap_{kind}__valid"] = v
"""


def _buffers():
    rng = np.random.default_rng(11)
    valid = rng.random((3, 24)) < 0.6
    valid[2] = False  # an instance with nothing received
    return dict(valid=valid,
                out_i=rng.integers(0, 48, (3, 24)).astype(np.int32),
                out_j=rng.integers(0, 48, (3, 24)).astype(np.int32),
                out_w=rng.random((3, 24)).astype(np.float32))


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def matrices(tmp_path_factory):
    """The JAX child (in a thread) beside the port's 2x4 and 2x2 spawns.
    Returns {"jax": its outputs, (pr, pc): the ranks' records}."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_reference, REFERENCE, _buffers(),
                        tmp_path_factory.mktemp("chaos_jax"), 8)
        out = {}
        for shape in ((2, 4), (2, 2)):
            ranks = run_grid(*shape, [("m", "chaos", {})],
                             tmp_path_factory.mktemp(f"chaos{shape[0]}"
                                                     f"x{shape[1]}"),
                             timeout=GRID_TIMEOUT_S[shape])
            out[shape] = [r["m"] for r in ranks]
        out["jax"] = fut.result(timeout=1200)
    return out


def _cases(records):
    return [(r["fault"], r["mode"]) for r in records]


# --------------------------------------------------------------------------
# the matrix
# --------------------------------------------------------------------------


def test_matrix_2x4_over_8_gloo_ranks_equals_jax(matrices):
    want = json.loads(str(matrices["jax"]["records"]))
    assert len(want) == 29 and all(r["ok"] for r in want)
    ranks = matrices[2, 4]
    assert len(ranks) == 8
    for rank, records in enumerate(ranks):
        assert not isinstance(records, tuple), records  # no rank raised
        chaos.assert_all_ok(records)
        assert _cases(records) == _cases(want), rank


def test_2x4_rank_loss_shrinks_to_1x4(matrices):
    for rank, records in enumerate(matrices[2, 4]):
        (rec,) = [r for r in records if r["fault"] == "device_loss_partial"]
        if rank < 4:  # the surviving row
            assert "grid 1x4 (fused, shrunk)" in rec["detail"]
        else:  # outside the rectangle: its own local chain
            assert "local torch" in rec["detail"]
    want = {r["fault"]: r["detail"] for r in json.loads(
        str(matrices["jax"]["records"]))}
    assert want["device_loss_partial"] == \
        "served by grid 1x4 (fused, shrunk) after 1 attempt(s)"


def test_matrix_2x2_over_4_gloo_ranks(matrices):
    ranks = matrices[2, 2]
    assert len(ranks) == 4
    for records in ranks:
        assert not isinstance(records, tuple), records
        chaos.assert_all_ok(records)
        assert len(records) == 29
    assert ranks[0] == ranks[1]  # the surviving row's ranks agree


def test_matrix_1x1_in_process():
    records = chaos.assert_all_ok(
        chaos.run_chaos_matrix(1, 1, device=CPU, log=_quiet))
    cases = _cases(records)
    assert len(cases) == 28  # no partial rank loss on one rank
    assert ("device_loss_partial", "survive") not in cases
    details = {r["fault"] + r["mode"]: r["detail"] for r in records}
    assert details["backend_persistentsurvive"] == \
        "served by local reference (degraded) after 4 attempt(s)"


# --------------------------------------------------------------------------
# injector mechanics
# --------------------------------------------------------------------------


def test_selected_equals_jax(matrices):
    valid = torch.from_numpy(_buffers()["valid"])
    for seed in (0, 7, 8):
        got = chaos._selected(valid, seed=seed, count=3).numpy()
        np.testing.assert_array_equal(got, matrices["jax"][f"selected{seed}"])
        assert not (got & ~valid.numpy()).any()
    assert chaos._selected(valid, 7, 3).sum() == 6  # 3 per non-empty row


@pytest.mark.parametrize("kind", chaos.EXCHANGE_FAULTS)
def test_exchange_taps_equal_jax(matrices, kind):
    buf = _buffers()
    valid = torch.from_numpy(buf["valid"])
    outs = [torch.from_numpy(buf[k]) for k in ("out_i", "out_j", "out_w")]
    tap = chaos._exchange_tap(chaos.FaultSpec(kind, stage=1, seed=7,
                                              count=2))
    o, v = tap(1, outs, valid)
    jx = matrices["jax"]
    for name, x in zip(("i", "j", "w"), o):
        want = jx[f"tap_{kind}__{name}"]
        assert x.numpy().tobytes() == want.tobytes(), name
    np.testing.assert_array_equal(v.numpy(), jx[f"tap_{kind}__valid"])
    # the other stage passes through untouched
    o2, v2 = tap(2, outs, valid)
    assert o2 is outs and v2 is valid


@pytest.mark.parametrize("n", [48, 32])
def test_pick_instance_equals_jax(matrices, n):
    deg, k = {48: (6.0, 3), 32: (5.0, 1)}[n]
    p, r = chaos._pick_instance(n, deg, min_awac_iters=k, device=CPU)
    jx = matrices["jax"]
    for f in ("row", "col", "val"):
        assert getattr(p, f).numpy().tobytes() == \
            jx[f"pick{n}__{f}"].tobytes(), f
    assert r.mate_row.numpy().tobytes() == jx[f"pick{n}__mate_row"].tobytes()
    assert int(r.awac_iters) == int(jx[f"pick{n}__iters"]) >= k


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        chaos.FaultSpec("meteor_strike")
    with pytest.raises(ValueError, match="stage"):
        chaos.FaultSpec("drop", stage=3)


def test_inject_installs_and_restores_taps():
    assert dist._EXCHANGE_TAP is None and batch._CONVERGENCE_TAP is None
    with chaos.inject(chaos.FaultSpec("drop", stage=1)):
        assert dist._EXCHANGE_TAP is not None
        assert batch._CONVERGENCE_TAP is None
    assert dist._EXCHANGE_TAP is None
    with chaos.inject(chaos.FaultSpec("flip_converged")):
        assert batch._CONVERGENCE_TAP is not None
        assert dist._EXCHANGE_TAP is None
    assert batch._CONVERGENCE_TAP is None


def _problem(n=16, seed=0):
    return MatchingProblem.from_graph(
        graph.generate(n, avg_degree=4.0, seed=seed), device=CPU)


def test_failing_backend_and_grid_count_and_restore():
    orig_s, orig_b = single._awpm, batch._awpm_batched
    with chaos.failing_backend("torch", fail_times=2) as state:
        with pytest.raises(TransientFault):
            solve(_problem(), SolveOptions(backend="torch"))
        assert state["n"] == 1
        assert bool(solve(_problem(), SolveOptions(backend="reference"))
                    .perfect)
        pb = MatchingProblem.stack([graph.generate(8, seed=0)] * 2,
                                   device=CPU)
        with pytest.raises(TransientFault):
            solve(pb)  # "auto" resolves to "torch" on the CPU
        assert state["n"] == 2
        assert bool(solve(pb).perfect.all())  # fail_times spent
    assert single._awpm is orig_s and batch._awpm_batched is orig_b
    orig = dist._DistBatchedAWPM.run
    grid = dist.make_grid(1, 1, device=CPU)
    with chaos.failing_grid(fail_times=1) as state:
        with pytest.raises(TransientFault, match="grid engine"):
            solve(_problem(), SolveOptions(grid=grid))
        assert bool(solve(_problem(), SolveOptions(grid=grid)).perfect)
    assert state["n"] == 1 and dist._DistBatchedAWPM.run is orig


def test_flip_converged_detected_by_convergence_audit():
    p, _ = chaos._pick_instance(48, 6.0, min_awac_iters=3, device=CPU)
    pb = MatchingProblem.stack([p, p], device=CPU)
    with chaos.inject(chaos.FaultSpec("flip_converged", count=1)):
        with pytest.raises(VerificationError) as exc:
            resilient_solve(
                pb, resilience=ResilientOptions(verify_convergence=True))
        # without the audit the premature result is served
        rr = resilient_solve(pb)
        assert (rr.result.awac_iters == 1).all()
    assert all(a.outcome == "verify_failed"
               for a in exc.value.report.attempts)


def test_nan_input_detected_or_sanitized():
    p = _problem()
    ref = solve(p)
    real = p.row < p.n
    p_nan = MatchingProblem.from_coo(p.row[real].numpy(),
                                     p.col[real].numpy(),
                                     p.val[real].numpy(), p.n,
                                     capacity=int(real.sum()) + 2,
                                     device=CPU)
    r, c, v = (x.clone() for x in (p_nan.row, p_nan.col, p_nan.val))
    pad = int(torch.nonzero(r >= p.n)[-1])
    r[pad], c[pad], v[pad] = 0, 0, float("nan")
    p_nan = MatchingProblem(row=r, col=c, val=v, n=p.n)
    with pytest.raises(PreflightError):
        solve(p_nan)
    rr = resilient_solve(p_nan, SolveOptions(on_invalid="sanitize"))
    assert torch.equal(rr.result.mate_row, ref.mate_row)


def test_assert_all_ok_raises_on_silent_corruption():
    records = [
        {"fault": "drop@stage1", "mode": "detect", "ok": True, "detail": ""},
        {"fault": "drop@stage1", "mode": "survive", "ok": False,
         "detail": "served a corrupted matching"},
    ]
    with pytest.raises(AssertionError, match="drop@stage1"):
        chaos.assert_all_ok(records)
    assert chaos.assert_all_ok(records[:1]) == records[:1]


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.runtime.chaos",
                           *args], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=REPO)


def test_cli_runs_the_matrix_on_gloo_ranks():
    proc = _cli("--device", "cpu", "--pr", "2", "--pc", "1")
    assert proc.returncode == 0, proc.stderr
    assert "ALL 29 CASES OK on each of the 2 ranks of the 2x1 grid" \
        in proc.stdout
    assert "device_loss_partial      survive  served by grid 1x1 (fused, " \
        "shrunk)" in proc.stdout


def test_cli_needs_the_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _cli()
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_matrix_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the local rungs launch the AWAC "
                    "kernels (CUDA C++ for sm_90a, no CPU mode)")
    proc = _cli(timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "ALL 28 CASES OK on the 1x1 grid" in proc.stdout
    assert "served by local cuda_persistent (degraded)" in proc.stdout
