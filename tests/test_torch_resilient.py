"""The port's guarded execution (``repro_torch.runtime.resilient``) and
straggler monitor against the JAX package's, and the guard on its own.

One JAX child runs the JAX suite's cases (``tests/test_resilient.py``)
on the same instances: clean serves with the certificate, the verifier
on corrupted results, transient and persistent backend failures, a dying
1x1 grid engine, a dead fleet, every rung failing, a flipped convergence
mask, an exchange fault, the deadline and a fatal request, and
``ResilientMatcher``. Held to it:

  - the same mates, rounds and (through the certificate) duals, bit for
    bit, and weights within rtol 1e-6 (a float32 sum, in another order
    than XLA's);
  - the same ``verify_result`` failure strings on the same corruptions;
  - the same attempts (rung, outcome, retry) and served rung, with the
    rung labels mapped: JAX's local "xla" is the port's "torch" (the
    plain sweep "auto" resolves to on the CPU), "pallas" is "cuda" and
    "pallas_persistent" is "cuda_persistent"; grid labels are unchanged.
    The backend failures hit the rungs above "reference": "xla" and
    "pallas" in JAX, "torch" here;
  - ``StragglerMonitor``'s EWMAs and flags on one record stream.

Every solve here runs on the CPU; the card's cases are marked ``gpu``
and must be served by their first rung (the persistent kernel), never
degraded.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    InfeasibleProblemError,
    MatchingProblem,
    SolveOptions,
    graph,
    make_grid,
    solve,
)
from repro_torch.core.dual import DualCertificate  # noqa: E402
from repro_torch.kernels.backend import KernelBuildError  # noqa: E402
from repro_torch.runtime import chaos, elastic  # noqa: E402
from repro_torch.runtime.resilient import (  # noqa: E402
    DeadlineExceededError,
    ResilientMatcher,
    ResilientOptions,
    TransientFault,
    VerificationError,
    _build_rungs,
    _classify,
    resilient_solve,
    verify_result,
)
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: E402
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


CPU = "cpu"
LABELS = {"local xla": "local torch", "local pallas": "local cuda",
          "local pallas_persistent": "local cuda_persistent"}


def _problem(n=16, seed=0):
    return MatchingProblem.from_graph(
        graph.generate(n, avg_degree=4.0, seed=seed), device=CPU)


def _grid():
    return make_grid(1, 1, device=CPU)


def _story(report):
    return [(a.rung, a.outcome, a.retry) for a in report.attempts]


REFERENCE = r"""
import dataclasses, json
import jax
from repro.core import MatchingProblem, SolveOptions, graph, solve
from repro.runtime import chaos, elastic
from repro.runtime.resilient import (
    DeadlineExceededError, ResilientMatcher, ResilientOptions,
    TransientFault, VerificationError, _build_rungs, resilient_solve,
    verify_result)
from repro.runtime.straggler import StragglerMonitor

def problem(n=16, seed=0):
    return MatchingProblem.from_graph(graph.generate(n, avg_degree=4.0,
                                                     seed=seed))

mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))

def story(report):
    return [[a.rung, a.outcome, a.retry] for a in report.attempts]

def keep(name, rr):
    r = rr.result
    OUT[name + "__mr"] = np.asarray(r.mate_row)
    OUT[name + "__mc"] = np.asarray(r.mate_col)
    OUT[name + "__w"] = np.asarray(r.weight)
    OUT[name + "__it"] = np.asarray(r.awac_iters)
    OUT[name + "__story"] = np.array(json.dumps(
        [story(rr.report), rr.report.backend_used, rr.report.degraded]))

def raised(name, fn):
    try:
        fn()
        OUT[name + "__raised"] = np.array(json.dumps(["none", []]))
    except (DeadlineExceededError, VerificationError) as e:
        OUT[name + "__raised"] = np.array(json.dumps(
            [type(e).__name__, story(e.report),
             [a.detail for a in e.report.attempts]]))
    except Exception as e:
        OUT[name + "__raised"] = np.array(json.dumps([type(e).__name__, []]))

p = problem()
rr = resilient_solve(p, resilience=ResilientOptions(certify=True,
                                                    verify_convergence=True))
keep("clean", rr)
OUT["clean__u"], OUT["clean__v"] = rr.report.certificate.potentials()
OUT["clean__bound"] = np.array(rr.report.certificate.upper_bound)

# the verifier on corrupted results
res = solve(p)
n = p.n
fails = {}
mr = np.asarray(res.mate_row).copy(); mr[0] = mr[1]
fails["two_to_one"] = verify_result(p, dataclasses.replace(res, mate_row=mr))
fails["weight"] = verify_result(p, dataclasses.replace(
    res, weight=np.asarray(res.weight) + 1.0))
fails["perfect"] = verify_result(p, dataclasses.replace(
    res, perfect=np.asarray(False)))
mc = np.asarray(res.mate_col).copy(); mc[[0, 1]] = mc[[1, 0]]
fails["inverse"] = verify_result(p, dataclasses.replace(res, mate_col=mc))
fails["shape"] = verify_result(p, dataclasses.replace(
    res, mate_row=np.asarray(res.mate_row)[:-1]))
mr = np.asarray(res.mate_row).copy(); mr[3] = n + 5
fails["range"] = verify_result(p, dataclasses.replace(res, mate_row=mr))
mr = np.asarray(res.mate_row).copy(); mc = np.asarray(res.mate_col).copy()
j0, j1 = 0, 5
i0, i1 = mr[j0], mr[j1]
mr[j0], mr[j1] = i1, i0
mc[i1], mc[i0] = j0, j1
fails["swap"] = verify_result(p, dataclasses.replace(res, mate_row=mr,
                                                     mate_col=mc))
pb = MatchingProblem.stack([problem(seed=0), problem(seed=1)])
resb = solve(pb)
mc = np.asarray(resb.mate_col).copy(); mc[1, n] = 0
fails["batched"] = verify_result(pb, dataclasses.replace(resb, mate_col=mc))
OUT["fails"] = np.array(json.dumps({k: list(v) for k, v in fails.items()}))

# retry + degradation
with chaos.failing_backend("xla", "pallas", fail_times=1):
    keep("transient", resilient_solve(p))
with chaos.failing_backend("xla", "pallas"):
    keep("persistent", resilient_solve(p))
with chaos.failing_grid():
    keep("grid_down", resilient_solve(p, SolveOptions(grid=mesh)))
dead = elastic.fail_hosts(elastic.initial_fleet(mesh),
                          [np.asarray(mesh.devices)[0, 0].id])
keep("dead_fleet", resilient_solve(p, SolveOptions(grid=mesh), fleet=dead))
keep("grid_clean", resilient_solve(p, SolveOptions(grid=mesh,
                                                   exchange_check=True)))
with chaos.inject(chaos.FaultSpec("drop", stage=1, seed=7)):
    keep("exchange", resilient_solve(p, SolveOptions(grid=mesh,
                                                     exchange_check=True)))
with chaos.failing_backend("xla", "pallas", "reference",
                           exc_type=RuntimeError):
    raised("all_fail", lambda: resilient_solve(
        p, SolveOptions(backend="pallas"),
        resilience=ResilientOptions(max_retries=0, backoff_s=0.0)))

planted, _ = chaos._pick_instance(48, 6.0, min_awac_iters=3)
ropts = ResilientOptions(verify_convergence=True)
with chaos.inject(chaos.FaultSpec("flip_converged", count=1)):
    raised("flip_detect", lambda: resilient_solve(
        MatchingProblem.stack([planted, planted]), resilience=ropts))
    keep("flip_survive", resilient_solve(planted, SolveOptions(grid=mesh),
                                         resilience=ropts))

labels = {}
for name, opts in (("pallas", SolveOptions(backend="pallas")),
                   ("xla", SolveOptions(backend="xla")),
                   ("auto", SolveOptions()),
                   ("grid", SolveOptions(grid=mesh, exchange_check=True))):
    labels[name] = [lbl for lbl, _ in _build_rungs(opts)]
labels["dead"] = [lbl for lbl, _ in _build_rungs(SolveOptions(grid=mesh),
                                                 fleet=dead)]
OUT["labels"] = np.array(json.dumps(labels))

m = ResilientMatcher(p)
keep("matcher", m(p))
keep("matcher2", m(p))
with chaos.failing_backend("xla", "pallas"):
    keep("matcher_degraded", ResilientMatcher(p)(p))
mb = ResilientMatcher(pb, resilience=ResilientOptions(certify=True))
keep("matcher_batch", mb(pb))

mon = StragglerMonitor(alpha=0.3, threshold=1.5, warmup=3)
for step, rank, dt in IN["straggle"].tolist():
    mon.record(int(step), float(dt), rank=int(rank))
OUT["straggle"] = np.array(json.dumps(
    [sorted(mon.ewma.items()), mon.slow_ranks(),
     [mon.slow_steps(r) for r in range(4)], mon.history]))
"""


def _straggle():
    rng = np.random.default_rng(3)
    rows = []
    for step in range(12):
        for rank in range(4):
            dt = 0.01 * (1.0 + 0.1 * rng.random())
            if rank == 2 and step >= 6:
                dt *= 4.0
            if rank == 0 and step == 9:
                dt *= 5.0
            rows.append((step, rank, dt))
    return np.array(rows)


@pytest.fixture(scope="module")
def jax_guard(tmp_path_factory):
    return run_reference(REFERENCE, {"straggle": _straggle()},
                         tmp_path_factory.mktemp("resilient"))


def _mapped(story):
    attempts, used, degraded = story
    return ([[LABELS.get(r, r), o, t] for r, o, t in attempts],
            LABELS.get(used, used), degraded)


def _check(jax_guard, name, rr):
    import json

    r = rr.result
    for k, got in (("mr", r.mate_row), ("mc", r.mate_col),
                   ("it", r.awac_iters)):
        want = jax_guard[f"{name}__{k}"]
        got = got.numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k
    # a float32 sum, in another order than XLA's
    np.testing.assert_allclose(r.weight.numpy(), jax_guard[f"{name}__w"],
                               rtol=1e-6)
    want = _mapped(json.loads(str(jax_guard[f"{name}__story"])))
    got = ([list(a) for a in _story(rr.report)], rr.report.backend_used,
           rr.report.degraded)
    assert got == want


def _raised(fn):
    try:
        fn()
    except (DeadlineExceededError, VerificationError) as e:
        return [type(e).__name__, [list(a) for a in _story(e.report)],
                [a.detail for a in e.report.attempts]]
    return ["none", []]


def test_clean_serve_with_certificate_equals_jax(jax_guard):
    p = _problem()
    rr = resilient_solve(p, resilience=ResilientOptions(
        certify=True, verify_convergence=True))
    _check(jax_guard, "clean", rr)
    cert = rr.report.certificate
    assert isinstance(cert, DualCertificate)
    u, v = cert.potentials()
    assert u.tobytes() == jax_guard["clean__u"].tobytes()
    assert v.tobytes() == jax_guard["clean__v"].tobytes()
    assert cert.upper_bound == float(jax_guard["clean__bound"])
    assert rr.report.backend_used == "local torch" and not rr.report.degraded
    split = rr.report.split
    assert {"verify_s", "audit_s", "certify_s"} <= set(split)
    assert "host_bytes" not in split  # CPU tensors are read in place


def _corrupt(p, res, kind):
    n = p.n
    if kind == "two_to_one":
        mr = res.mate_row.clone()
        mr[0] = mr[1]
        return dataclasses.replace(res, mate_row=mr)
    if kind == "weight":
        return dataclasses.replace(res, weight=res.weight + 1.0)
    if kind == "perfect":
        return dataclasses.replace(res, perfect=torch.tensor(False))
    if kind == "inverse":
        mc = res.mate_col.clone()
        mc[[0, 1]] = mc[[1, 0]]
        return dataclasses.replace(res, mate_col=mc)
    if kind == "shape":
        return dataclasses.replace(res, mate_row=res.mate_row[:-1])
    if kind == "range":
        mr = res.mate_row.clone()
        mr[3] = n + 5
        return dataclasses.replace(res, mate_row=mr)
    if kind == "swap":
        mr, mc = res.mate_row.clone(), res.mate_col.clone()
        i0, i1 = int(mr[0]), int(mr[5])
        mr[0], mr[5] = i1, i0
        mc[i1], mc[i0] = 0, 5
        return dataclasses.replace(res, mate_row=mr, mate_col=mc)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["two_to_one", "weight", "perfect",
                                  "inverse", "shape", "range", "swap",
                                  "batched"])
def test_verify_result_failures_equal_jax(jax_guard, kind):
    import json

    want = json.loads(str(jax_guard["fails"]))[kind]
    assert want  # every corruption is caught
    if kind == "batched":
        pb = MatchingProblem.stack([_problem(seed=0), _problem(seed=1)],
                                   device=CPU)
        res = solve(pb)
        mc = res.mate_col.clone()
        mc[1, pb.n] = 0
        got = verify_result(pb, dataclasses.replace(res, mate_col=mc))
        assert all(f.startswith("[instance 1]") for f in got)
    else:
        p = _problem()
        got = verify_result(p, _corrupt(p, solve(p), kind))
    assert list(got) == want
    assert verify_result(_problem(), solve(_problem())) == ()


@pytest.mark.parametrize("name", ["transient", "persistent", "grid_down",
                                  "dead_fleet", "grid_clean", "exchange"])
def test_attempts_and_results_equal_jax(jax_guard, name):
    p = _problem()
    grid = _grid()
    if name == "transient":
        with chaos.failing_backend("torch", fail_times=1):
            rr = resilient_solve(p)
    elif name == "persistent":
        with chaos.failing_backend("torch"):
            rr = resilient_solve(p)
    elif name == "grid_down":
        with chaos.failing_grid():
            rr = resilient_solve(p, SolveOptions(grid=grid))
    elif name == "dead_fleet":
        dead = elastic.fail_hosts(elastic.initial_fleet(grid), [0])
        rr = resilient_solve(p, SolveOptions(grid=grid), fleet=dead)
    elif name == "grid_clean":
        rr = resilient_solve(p, SolveOptions(grid=grid, exchange_check=True))
    else:
        with chaos.inject(chaos.FaultSpec("drop", stage=1, seed=7)):
            rr = resilient_solve(p, SolveOptions(grid=grid,
                                                 exchange_check=True))
    _check(jax_guard, name, rr)


def test_every_rung_failing_equals_jax(jax_guard):
    import json

    with chaos.failing_backend("cuda", "torch", "reference",
                               exc_type=RuntimeError):
        got = _raised(lambda: resilient_solve(
            _problem(), SolveOptions(backend="cuda"),
            resilience=ResilientOptions(max_retries=0, backoff_s=0.0)))
    name, story, details = json.loads(str(jax_guard["all_fail__raised"]))
    assert got[0] == name == "VerificationError"
    assert got[1] == _mapped([story, None, False])[0]
    assert len(got[1]) == 3  # one attempt per local rung, no retries
    assert all(d.startswith("RuntimeError: injected") for d in got[2])


def test_flip_converged_detected_and_survived_like_jax(jax_guard):
    import json

    planted, _ = chaos._pick_instance(48, 6.0, min_awac_iters=3, device=CPU)
    ropts = ResilientOptions(verify_convergence=True)
    with chaos.inject(chaos.FaultSpec("flip_converged", count=1)):
        got = _raised(lambda: resilient_solve(
            MatchingProblem.stack([planted, planted], device=CPU),
            resilience=ropts))
        rr = resilient_solve(planted, SolveOptions(grid=_grid()),
                             resilience=ropts)
    name, story, details = json.loads(str(jax_guard["flip_detect__raised"]))
    assert got[0] == name == "VerificationError"
    assert got[1] == _mapped([story, None, False])[0]
    assert got[2] == details  # the audit's own words, per instance
    _check(jax_guard, "flip_survive", rr)


def test_rung_labels_equal_jax(jax_guard):
    import json

    want = json.loads(str(jax_guard["labels"]))
    grid = _grid()
    dead = elastic.fail_hosts(elastic.initial_fleet(grid), [0])
    cases = {"pallas": (SolveOptions(backend="cuda"), None),
             "xla": (SolveOptions(backend="torch"), None),
             "auto": (SolveOptions(), None),
             "grid": (SolveOptions(grid=grid, exchange_check=True), None),
             "dead": (SolveOptions(grid=grid), dead)}
    for name, (opts, fleet) in cases.items():
        got = [lbl for lbl, _ in _build_rungs(opts, torch.device(CPU),
                                              fleet=fleet)]
        assert got == [LABELS.get(x, x) for x in want[name]], name
    # the grid rung's fallbacks lose every distributed knob
    for label, opts in _build_rungs(
            SolveOptions(grid=grid, exchange_check=True, packed=True),
            torch.device(CPU))[1:]:
        assert label.startswith("local ")
        assert opts.grid is None and not opts.exchange_check \
            and not opts.packed
    # on the card "auto" starts the chain at the persistent kernel
    assert [lbl for lbl, _ in _build_rungs(
        SolveOptions(), torch.device("cuda"))] == [
        "local cuda_persistent", "local cuda", "local torch",
        "local reference"]


@pytest.mark.parametrize("name", ["matcher", "matcher2", "matcher_degraded",
                                  "matcher_batch"])
def test_resilient_matcher_equals_jax(jax_guard, name):
    p = _problem()
    if name in ("matcher", "matcher2"):
        m = ResilientMatcher(p)
        rr = m(p)
        if name == "matcher2":
            rr = m(p)
            assert len(m._matchers) == 1  # one planned Matcher, reused
    elif name == "matcher_degraded":
        with chaos.failing_backend("torch"):
            rr = ResilientMatcher(p)(p)
    else:
        pb = MatchingProblem.stack([_problem(seed=0), _problem(seed=1)],
                                   device=CPU)
        rr = ResilientMatcher(pb, resilience=ResilientOptions(
            certify=True))(pb)
        assert len(rr.report.certificate) == 2
    _check(jax_guard, name, rr)


def test_straggler_monitor_equals_jax(jax_guard):
    import json

    mon = StragglerMonitor(alpha=0.3, threshold=1.5, warmup=3)
    for step, rank, dt in _straggle().tolist():
        mon.record(int(step), float(dt), rank=int(rank))
    ewma, slow, steps, history = json.loads(str(jax_guard["straggle"]))
    assert [[r, t] for r, t in sorted(mon.ewma.items())] == ewma
    assert mon.slow_ranks() == slow == [2]
    assert [mon.slow_steps(r) for r in range(4)] == steps
    assert [list(h) for h in mon.history] == history


# --------------------------------------------------------------------------
# the guard on its own
# --------------------------------------------------------------------------


def test_options_validation():
    with pytest.raises(ValueError, match="deadline_s"):
        ResilientOptions(deadline_s=0.0)
    with pytest.raises(ValueError, match="max_retries"):
        ResilientOptions(max_retries=-1)
    with pytest.raises(TypeError, match="MatchingProblem"):
        resilient_solve("p")


def test_deadline_expires_with_report():
    with chaos.failing_backend("torch", "reference"):
        with pytest.raises(DeadlineExceededError) as exc:
            resilient_solve(_problem(), resilience=ResilientOptions(
                deadline_s=0.2, max_retries=1000, backoff_s=0.05))
    assert exc.value.report.attempts
    assert all(a.outcome == "transient" for a in exc.value.report.attempts)


def test_request_errors_propagate_untouched():
    g = graph.generate(10, avg_degree=3.0, seed=1)
    keep = g.col != 4
    infeasible = MatchingProblem.from_coo(g.row[keep], g.col[keep],
                                          g.val[keep], g.n, device=CPU)
    with pytest.raises(InfeasibleProblemError):
        resilient_solve(infeasible)
    p = _problem()
    with pytest.raises(ValueError, match="does not fit"):
        resilient_solve(p, warm_start=(np.zeros(3), np.zeros(3)))


def test_classify():
    from repro_torch.core.dist import ExchangeIntegrityError
    from repro_torch.core.preflight import PreflightError, PreflightReport

    assert _classify(PreflightError(PreflightReport(issues=()))) == "fatal"
    assert _classify(ValueError("x")) == "fatal"
    assert _classify(ExchangeIntegrityError("x")) == "integrity"
    assert _classify(TransientFault("x")) == "transient"
    assert _classify(RuntimeError("CUDA error: an illegal memory access")) \
        == "transient"
    assert _classify(KernelBuildError("nvcc failed on awac_sweep.cu")) \
        == "fatal"


def test_kernel_build_failure_propagates_not_degraded():
    # a rung whose kernels do not build raises at once: no retry, and no
    # lower rung serves the plain version in its place
    with chaos.failing_backend("torch", exc_type=KernelBuildError) as st:
        with pytest.raises(KernelBuildError, match="injected"):
            resilient_solve(_problem())
    assert st["n"] == 1


def test_warm_start_threads_through_every_rung():
    p = _problem()
    prev = solve(p)
    rr = resilient_solve(p, warm_start=prev)
    assert rr.result.execution.warm_started
    assert int(rr.result.awac_iters) == 1
    assert torch.equal(rr.result.mate_row, prev.mate_row)


def test_matcher_needs_a_device_and_keeps_to_it():
    p = _problem()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ResilientMatcher(p.spec)
    m = ResilientMatcher(p.spec, device=CPU)
    assert m.device.type == "cpu" and "local torch" in repr(m)
    assert torch.equal(m(p).result.mate_row, solve(p).mate_row)
    with pytest.raises(ValueError, match="chain was built for"):
        ResilientMatcher(p.spec, device="meta")(p)


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the first rungs launch the AWAC "
                    "kernels (CUDA C++ for sm_90a, no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_build_failure_raises_not_served_plain(cuda, monkeypatch,
                                                    tmp_path):
    from repro_torch.kernels import backend

    # a flag nvcc refuses: a real build, in a build root of its own, fails
    monkeypatch.setattr(backend, "_LIB", None)
    monkeypatch.setattr(backend, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(backend, "NVCC_FLAGS",
                        backend.NVCC_FLAGS + ("--no-such-nvcc-flag",))
    g = graph.generate(256, avg_degree=4.0, kind="antigreedy", seed=0)
    p = MatchingProblem.from_graph(g)
    with pytest.raises(KernelBuildError, match="nvcc failed"):
        resilient_solve(p)
    with pytest.raises(KernelBuildError, match="nvcc failed"):
        ResilientMatcher(p.spec)(p)


@pytest.mark.gpu
def test_card_serves_by_the_persistent_kernel_not_degraded(cuda):
    from repro_torch.kernels import backend

    g = graph.generate(2048, avg_degree=8.0, kind="antigreedy", seed=0)
    p = MatchingProblem.from_graph(g)
    backend.reset_launch_counts()
    rr = resilient_solve(p, resilience=ResilientOptions(
        verify_convergence=True))
    assert backend.launch_counts()["awac_persistent"] >= 1
    assert rr.report.backend_used == "local cuda_persistent"
    assert not rr.report.degraded
    want = solve(p)
    assert torch.equal(rr.result.mate_row, want.mate_row)
    with chaos.failing_backend("cuda_persistent"):
        backend.reset_launch_counts()
        k1 = resilient_solve(p)
    assert k1.report.backend_used == "local cuda"
    assert backend.launch_counts()["awac_sweep"] == int(k1.result.awac_iters)
    assert torch.equal(k1.result.mate_row, want.mate_row)
    pb = MatchingProblem.stack([g, g])
    mb = ResilientMatcher(pb)(pb)
    assert mb.report.backend_used == "local cuda_persistent"
    assert not mb.report.degraded
