"""The port's tracer (``repro_torch.obs``) on ``solve()``'s path, on the CPU.

Off, it records nothing. On, ``solve()`` and the engines give the same
mates, duals, weights and AWAC rounds as off; each call's spans nest under
one ``solve`` root with a call id of its own; ``greedy.rounds`` and
``mcm.layers`` equal the loops' counts taken by wrapping the loop bodies;
and ``d2h.reads`` equals the host reads of tensors (``tolist``, ``item``,
``cpu``, ``bool``, ``int`` and ``nonzero``'s count) made inside the call, counted by patching
``torch.Tensor``, on the local routes and on a 1x1 grid over gloo. Under a
profiler the spans are annotations, the per-iteration steps and the reads
are not.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MatchingProblem,
    SolveOptions,
    batch,
    graph,
    make_grid,
    single,
    solve,
)

N = 64
READS = ("tolist", "item", "cpu", "__bool__", "__int__", "nonzero")
BACKENDS = ("auto", "reference", "torch", "cuda", "cuda_persistent")
#: (batched, warm, grid) of each route through solve(); the grid is 1x1
ROUTES = {"single-cold": (False, False, False),
          "single-warm": (False, True, False),
          "batched-cold": (True, False, False),
          "batched-warm": (True, True, False),
          "grid-cold": (False, False, True),
          "grid-warm": (True, True, True)}
LOCAL = [name for name, (_, _, grid) in ROUTES.items() if not grid]
#: spans of one loop iteration (``obs.step``): never profiler annotations
STEPS = ("greedy.round", "mcm.layer")


@pytest.fixture(autouse=True)
def tracer_off():
    obs.disable()
    obs.take()
    yield
    obs.disable()
    obs.take()


def _graph(kind="powerlaw", seed=3):
    return graph.generate(N, avg_degree=5.0, kind=kind, seed=seed)


def _problem(batched: bool, seed: int = 3, device="cpu") -> MatchingProblem:
    if batched:
        return MatchingProblem.stack(
            [_graph("powerlaw", seed), _graph("uniform", seed + 1),
             _graph("antigreedy", seed + 2)], device=device)
    return MatchingProblem.from_graph(_graph("powerlaw", seed), device=device)


def _jittered(p: MatchingProblem) -> MatchingProblem:
    """The same pattern, its values jittered 5% (padding stays 0)."""
    g = torch.Generator().manual_seed(11)
    jitter = torch.randn(p.val.shape, generator=g).to(p.val.device)
    val = p.val * (1 + 0.05 * jitter).abs()
    return MatchingProblem(row=p.row, col=p.col, val=val, n=p.n)


def _route(name: str, backend: str = "auto", device="cpu"):
    """The calls of route ``name``: a cold solve, or a cold seed and a warm
    solve of jittered values from it (the seed made with the tracer off)."""
    batched, warm, grid = ROUTES[name]
    p = _problem(batched, device=device)
    opts = SolveOptions(backend=backend, grid=make_grid(
        1, 1, device=device) if grid else None)
    if not warm:
        return lambda: solve(p, opts)
    seed = solve(p, opts)
    q = _jittered(p)
    return lambda: solve(q, opts, warm_start=seed)


def _same(a, b):
    assert torch.equal(a.mate_row, b.mate_row)
    assert torch.equal(a.mate_col, b.mate_col)
    assert torch.equal(torch.as_tensor(a.awac_iters),
                       torch.as_tensor(b.awac_iters))
    assert torch.equal(torch.as_tensor(a.weight), torch.as_tensor(b.weight))
    assert torch.equal(torch.as_tensor(a.perfect), torch.as_tensor(b.perfect))


def test_off_records_nothing():
    for name in ROUTES:
        _route(name)()
    trace = obs.take()
    assert trace.spans == [] and trace.counts == {}
    assert not obs.enabled()


@pytest.mark.parametrize("name", list(ROUTES))
def test_solve_is_bit_identical_on_and_off(name):
    call = _route(name)
    off = call()
    obs.enable()
    on = call()
    obs.disable()
    _same(off, on)
    assert len(obs.take().calls()) == 1


def _engines():
    """(name, engine call) of the engines behind solve(), each returning
    (MatchState, iters), on the edges of a single and of a batched
    problem."""
    p, pb = _problem(False), _problem(True)
    seed, _ = batch._awpm_batched(pb.row, pb.col, pb.val, pb.n)
    q = _jittered(pb)
    return [
        ("single", lambda: single._awpm(p.row, p.col, p.val, p.n)),
        ("batched", lambda: batch._awpm_batched(pb.row, pb.col, pb.val,
                                                pb.n)),
        ("warm", lambda: batch._awpm_batched_from_state(
            q.row, q.col, q.val, q.n, seed.mate_row, seed.mate_col)),
    ]


def test_engines_give_the_same_duals_on_and_off():
    for name, call in _engines():
        st_off, it_off = call()
        obs.enable()
        st_on, it_on = call()
        obs.disable()
        for field in ("mate_row", "mate_col", "u", "v"):
            assert torch.equal(getattr(st_off, field),
                               getattr(st_on, field)), (name, field)
        assert torch.equal(torch.as_tensor(it_off), torch.as_tensor(it_on))


def _count_calls(monkeypatch, module, name, tally, key, measure=None):
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        tally[key] += 1 if measure is None else measure(out)
        return out

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("batched", [False, True])
def test_rounds_and_layers_equal_the_loops(monkeypatch, batched):
    tally = {"rounds": 0, "layers": 0}
    if batched:
        _count_calls(monkeypatch, batch, "greedy_commit", tally, "rounds")
        _count_calls(monkeypatch, batch, "bfs_commit", tally, "layers")
    else:
        _count_calls(monkeypatch, single, "greedy_round", tally, "rounds")
        _count_calls(monkeypatch, single, "_mcm_bfs", tally, "layers",
                     measure=lambda out: out[3])
    p = _problem(batched)
    obs.enable()
    solve(p)
    obs.disable()
    trace = obs.take()
    assert tally["layers"] > 0 and tally["rounds"] > 0
    assert trace.count("greedy.rounds") == tally["rounds"]
    assert trace.count("mcm.layers") == tally["layers"]
    assert len(trace.named("greedy.round")) == tally["rounds"]
    assert len(trace.named("mcm.layer")) == tally["layers"]


def test_single_and_batched_count_alike():
    """A single instance and the same instance as a batch of one run the
    same greedy rounds and BFS layers."""
    g = _graph()
    counts = []
    for p in (MatchingProblem.from_graph(g, device="cpu"),
              MatchingProblem.stack([g], device="cpu")):
        obs.enable()
        solve(p)
        obs.disable()
        t = obs.take()
        counts.append((t.count("greedy.rounds"), t.count("mcm.layers")))
    assert counts[0] == counts[1]


def _check_nesting(trace):
    by_id = {s.id: s for s in trace.spans}
    roots = trace.calls()
    assert len({r.call for r in roots}) == len(roots)
    assert all(r.call == r.id for r in roots)
    for s in trace.spans:
        if s.parent == 0:
            assert s.name == "solve"
            continue
        up = by_id[s.parent]
        assert up.call == s.call
        assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    assert set(trace.counts) <= {r.call for r in roots}


def test_spans_nest_under_one_root_a_call():
    obs.enable()
    for name in ROUTES:
        _route(name)()
    obs.disable()
    trace = obs.take()
    # each warm route made its seed too
    assert len(trace.calls()) == sum(2 if warm else 1
                                     for _, warm, _ in ROUTES.values())
    _check_nesting(trace)
    names = {s.name for s in trace.spans}
    assert {"solve", "preflight", "preflight.copy", "preflight.scan",
            "greedy", "greedy.round", "mcm", "mcm.layer", "mcm.flip",
            "warm_state", "warm.repair", "warm.topup", "warm.duals", "awac",
            "finish", "d2h.preflight", "d2h.greedy", "d2h.mcm_layer",
            "d2h.mcm_phase", "d2h.row_nnz", "d2h.finish", "d2h.grid",
            "d2h.grid_aux", "d2h.nonzero"} <= names
    # no read inside another read
    by_id = {s.id: s for s in trace.spans}
    assert not any(s.name.startswith("d2h.") and
                   by_id[s.parent].name.startswith("d2h.")
                   for s in trace.spans if s.parent)


def test_calls_on_two_threads_stay_apart():
    p = _problem(False)
    obs.enable()
    errors = []

    def work():
        try:
            for _ in range(3):
                solve(p)
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    obs.disable()
    assert not any(t.is_alive() for t in threads) and not errors
    trace = obs.take()
    assert len(trace.calls()) == 6
    _check_nesting(trace)


def _reads_of(monkeypatch, call):
    """(the tensor reads made inside ``call()``, its record), the tracer
    on."""
    seen = []
    inside = [False]
    for attr in READS:
        real = getattr(torch.Tensor, attr)

        def read(self, *args, _real=real, _attr=attr, **kwargs):
            if inside[0]:
                seen.append(_attr)
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, attr, read)
    obs.enable()
    inside[0] = True
    try:
        out = call()
    finally:
        inside[0] = False
        obs.disable()
    monkeypatch.undo()
    return seen, obs.take(), out


#: every route under every backend it takes (K2 runs no grid)
COVERAGE = [(name, backend) for name in ROUTES for backend in BACKENDS
            if not (ROUTES[name][2] and backend == "cuda_persistent")]


@pytest.mark.parametrize("name,backend", COVERAGE)
def test_every_read_of_the_device_is_counted(monkeypatch, name, backend):
    seen, trace, _ = _reads_of(monkeypatch, _route(name, backend))
    assert seen, "the route read nothing"
    assert trace.count("d2h.reads") == len(seen), sorted(seen)
    assert len([s for s in trace.spans if s.name.startswith("d2h.")]) \
        == len(seen)


#: the local routes on the card: through the kernels ("auto": K2, and the
#: MCM kernel on the single cold route) and through the plain versions
CARD = [(name, backend) for name in LOCAL for backend in ("auto", "torch")]


@pytest.mark.gpu
@pytest.mark.parametrize("name,backend", CARD)
def test_on_the_card(monkeypatch, name, backend):
    """The same answer on and off, and every read counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    call = _route(name, backend, device="cuda")
    off = call()
    seen, trace, on = _reads_of(monkeypatch, call)
    _same(off, on)
    assert trace.count("d2h.reads") == len(seen) > 0, sorted(seen)
    _check_nesting(trace)


@pytest.mark.gpu
def test_mcm_kernel_counts_as_the_plain_route(monkeypatch):
    """The single cold route through the MCM kernel ("auto") reads the card
    once for MCM (``d2h.mcm``) and counts the plain route's BFS layers and
    phases ("torch"), with ``mcm.kernel`` 1 against 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    counts = {}
    for backend in ("auto", "torch"):
        seen, trace, _ = _reads_of(monkeypatch,
                                   _route("single-cold", backend, "cuda"))
        assert trace.count("d2h.reads") == len(seen) > 0, sorted(seen)
        counts[backend] = (trace.count("mcm.kernel"),
                           trace.count("mcm.layers"),
                           trace.count("mcm.phases"),
                           len(trace.named("d2h.mcm")))
    assert counts["auto"][0] == 1 and counts["torch"][0] == 0
    assert counts["auto"][1:3] == counts["torch"][1:3]
    assert counts["auto"][1] > 0
    assert (counts["auto"][3], counts["torch"][3]) == (1, 0)


def test_primitives():
    obs.count("outside")  # off: nothing
    obs.enable()
    obs.count("outside", 2)
    with obs.span("a"):
        obs.count("k")
        with obs.span("b"):
            obs.count("k", 3)
            assert obs.flag(torch.tensor(True), "x") is True
        with obs.d2h("y"):
            pass
    with obs.span("c"):
        obs.count("m", 0)
    obs.disable()
    with obs.span("off"):
        pass
    trace = obs.take()
    assert obs.take().spans == []
    a, c = trace.calls("a")[0], trace.calls("c")[0]
    assert a.call != c.call
    assert trace.counts[0] == {"outside": 2}
    assert trace.counts[a.call] == {"k": 4, "d2h.reads": 2}
    assert trace.of([c]).count("m") == 0
    assert trace.of([c]).count("k") is None
    assert [s.name for s in trace.spans] == ["d2h.x", "b", "d2h.y", "a",
                                             "c"]
    assert trace.named("b")[0].parent == a.id
    assert obs.span("z") is obs.span("w")  # off: one shared null context


def test_spans_are_profiler_annotations():
    p = _problem(False)
    obs.enable(annotate="test::")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        solve(p)
    obs.disable()
    trace = obs.take()
    marks = [e.name for e in prof.events() if e.name.startswith("test::")]
    assert sorted(marks) == sorted(
        "test::" + s.name for s in trace.spans
        if s.name not in STEPS and not s.name.startswith("d2h."))
    assert {"test::solve", "test::mcm", "test::mcm.flip"} <= set(marks)
    assert trace.named("mcm.layer") and trace.named("d2h.finish")
    obs.enable()
    solve(p)  # no profiler: no annotation, the spans still recorded
    obs.disable()
    assert obs.take().calls()
