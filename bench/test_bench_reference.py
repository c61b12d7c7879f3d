"""The benchmark's yardstick on the CPU at small sizes: the generator
hits its sizes for every kind and gives the parent's patterns and values
where it did before, the plain reference gives the port's answers, every
lane of a batch is checked, and a lower precision fails the comparison."""
from __future__ import annotations

import dataclasses
import hashlib
import time

import pytest
import torch

from bench import control, harness
from bench.gen import values
from bench.gen.pattern import KINDS, band_of, make_lanes, make_pattern
from bench.gen.traffic import Mix, Stream
from bench.reference.awpm import Reference, preflight_issues
from bench.reference.check import LIMITS
from repro_torch.core import api

CPU = torch.device("cpu")
SMALL = {"powerlaw": dict(pattern="powerlaw", n=1500, nnz=7400),
         "uniform": dict(pattern="uniform", n=1200, nnz=21600),
         "circuit": dict(pattern="circuit", n=1500, nnz=7400),
         "antigreedy": dict(pattern="antigreedy", n=1500, nnz=7400),
         "banded": dict(pattern="banded", n=1200, nnz=9600),
         # one lane of each kind, at a tiny size
         "suite": dict(batch=5, kinds=list(KINDS), n=256, nnz=2048)}
#: a batched cold cell for the tests: no cell of ``BENCHMARK.json`` is
#: batched yet, so ``load_spec`` adds this one, under every metric that
#: the single-instance cold cells list but the MCM kernel's roofline, and
#: under ``mcm_layer_ms``, which only the batched engine's layers open
BATCH_CELL = "suite.cold"
CELLS = {"powerlaw_2m7.cold": "powerlaw", "uniform_1m5.cold": "uniform",
         "powerlaw_2m7.warm": "powerlaw", "uniform_1m5.warm": "uniform",
         BATCH_CELL: "suite"}
#: digests of the patterns and values (``pattern_digest``) and of the
#: answers served at the cells' small sizes (``served_digest``), as the
#: generator and the harness gave them before the suite's kinds and the
#: batched configurations came in: a single-instance configuration's
#: inputs and answers must not move
PARENT_PATTERNS = {
    ("uniform", 0): ("a5bd468b2ca4c3ac", "1317ebd22a600081"),
    ("uniform", 2**31 + 99): ("2df6feb9d0c1c58b", "d57f66b9591cabb5"),
    ("powerlaw", 0): ("bb70903d41b13683", "d1b848285d944775"),
    ("powerlaw", 2**31 + 99): ("26e2449c3b101739", "dca399998b4b8709"),
}
PARENT_SERVED = {"powerlaw_2m7.cold": "5853e948968a3979",
                 "uniform_1m5.cold": "1a170489b4e6d382",
                 "powerlaw_2m7.warm": "bc6bf396668e3e9e",
                 "uniform_1m5.warm": "45dc167b89606e80"}


#: the stand-in program's size: small enough for windows of 1,000 calls
TINY = dict(pattern="powerlaw", n=24, nnz=96)


def small_config(name: str) -> dict:
    return dict(SMALL[name])


class StandIn:
    """A test-only program in ``api.solve``'s place that answers at once
    with the plain reference's answer, in ``dtype`` (bfloat16: the
    control), or with a faulty one: ``alter(call, answer)`` may change the
    answer to call ``call`` (counted from the run's first call) where it is
    produced."""

    def __init__(self, dtype=torch.float32, alter=None):
        self.dtype, self.alter = dtype, alter
        self.refs: dict[int, Reference] = {}
        self.calls = 0

    def solve(self, problem, options=None, *, warm_start=None):
        key = problem.row.data_ptr()
        if key not in self.refs:
            self.refs[key] = Reference(problem.row, problem.col, problem.n,
                                       dtype=self.dtype)
        ref = self.refs[key]
        ans = ref.cold(problem.val) if warm_start is None else ref.warm(
            problem.val, warm_start.mate_row, warm_start.mate_col)
        out = api.MatchResult(
            mate_row=ans.mate_row.int(), mate_col=ans.mate_col.int(),
            weight=torch.tensor(float(ans.u[:-1].sum())
                                if self.dtype != torch.float32
                                else ans.weight(), dtype=torch.float64),
            awac_iters=torch.tensor(ans.rounds),
            perfect=torch.tensor(ans.perfect()))
        if self.alter is not None:
            out = self.alter(self.calls, out)
        self.calls += 1
        return out


class Counting(Reference):
    """The reference, counting the solves the check asks of it."""

    solves = 0

    def cold(self, val):
        Counting.solves += 1
        return super().cold(val)

    def warm(self, val, seed_row, seed_col):
        Counting.solves += 1
        return super().warm(val, seed_row, seed_col)


def run_standin(monkeypatch, cell: str, calls: int, seed: int):
    """One run of ``cell`` at the size ``TINY`` with a sound stand-in in
    ``api.solve``'s place, its window pinned to ``calls`` calls; returns
    the result, the tally, the ``harness.Held`` of the window and the
    reference's solves."""
    made, real = [], harness.Held

    def held(*args):
        made.append(real(*args))
        return made[-1]

    monkeypatch.setattr(api, "solve", StandIn().solve)
    monkeypatch.setattr(harness, "MOST_CALLS", {False: calls, True: calls})
    monkeypatch.setattr(harness, "Held", held)
    monkeypatch.setattr(harness, "Reference", Counting)
    monkeypatch.setattr(Counting, "solves", 0)
    result, tally = harness.run_cell(load_spec(), cell, seed, 3600.0, False,
                                     CPU, time.perf_counter(),
                                     config=dict(TINY))
    return result, tally, made[0], Counting.solves


def load_spec() -> dict:
    """``BENCHMARK.json`` with the tests' batched cell ``BATCH_CELL``."""
    spec = harness.load_spec()
    like = "powerlaw_2m7.cold"
    spec["workloads"].append(dict(harness.workload(spec, like),
                                  name=BATCH_CELL))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", ()) and m["name"] != "mcm_roofline":
            m["workloads"].append(BATCH_CELL)
    spec["per_layer"].append(
        {"name": "mcm_layer_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "MCM", "moves": "solve_ms",
         "workloads": [BATCH_CELL]})
    return spec


def digest(*tensors) -> str:
    d = hashlib.sha256()
    for t in tensors:
        d.update(t.contiguous().numpy().tobytes())
    return d.hexdigest()[:16]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 2**31 + 99])
def test_pattern_hits_n_and_nnz(kind, seed):
    n, nnz = 5000, 5000 * 6 + 7
    p = make_pattern(n, nnz, kind, seed, CPU)
    assert p.n == n and p.nnz == nnz and p.cap % 8 == 0 and p.cap >= nnz
    assert p.kind == kind and p.seed == seed
    row, col = p.row[:nnz].long(), p.col[:nnz].long()
    keys = row * n + col
    assert bool((keys[1:] > keys[:-1]).all())  # lex-sorted and distinct
    assert bool((p.row[nnz:] == n).all()) and bool((p.col[nnz:] == n).all())
    assert int(p.planted.sum()) == n  # the planted permutation, whole
    assert torch.equal(torch.sort(row[p.planted[:nnz]]).values,
                       torch.arange(n))
    assert torch.equal(torch.sort(col[p.planted[:nnz]]).values,
                       torch.arange(n))
    extra = ~p.planted[:nnz]
    if kind == "banded":  # every entry off the permutation in its band
        assert band_of(n, nnz) == 18
        assert int((col - row)[extra].abs().max()) <= 18
    else:  # the band holds a few of them only
        assert float(((col - row)[extra].abs() <= 18).float().mean()) < 0.05
    again = make_pattern(n, nnz, kind, seed, CPU)
    assert torch.equal(p.row, again.row) and torch.equal(p.col, again.col)
    assert torch.equal(p.planted, again.planted)


def test_pattern_rejects_a_count_that_cannot_fit():
    with pytest.raises(ValueError):
        make_pattern(10, 101, "uniform", 0, CPU)
    with pytest.raises(ValueError):
        make_pattern(10, 20, "striped", 0, CPU)
    with pytest.raises(ValueError):
        make_lanes(dict(batch=0, kinds=["uniform"], n=10, nnz=20), 0, CPU)


@pytest.mark.parametrize("kind,seed", list(PARENT_PATTERNS),
                         ids=[f"{k}-{s}" for k, s in PARENT_PATTERNS])
def test_single_patterns_and_values_are_the_parents(kind, seed):
    p = make_pattern(600, 600 * 6 + 5, kind, seed, CPU)
    v0, v1 = values.fresh(p, seed, 0), values.fresh(p, seed, 1)
    w = values.perturbed(p, v0, 0.02, seed, 1)
    got = (digest(p.row, p.col, p.planted), digest(v0, v1, w))
    assert got == PARENT_PATTERNS[kind, seed]
    (lane,) = make_lanes(dict(pattern=kind, n=600, nnz=600 * 6 + 5), seed,
                         CPU)
    assert digest(lane.row, lane.col, lane.planted) == got[0]


@pytest.mark.parametrize("cell", list(PARENT_SERVED))
def test_existing_cells_serve_the_parents_answers(cell):
    _, cfg, mix = harness.resolve(load_spec(), cell,
                                  small_config(CELLS[cell]))
    lanes = make_lanes(cfg, 5, CPU)
    caller = harness.Caller(api, lanes, False, Stream(mix, lanes), CPU)
    out = []
    for _ in range(4):
        (s,) = caller.call()
        out += [s.mate_row, s.mate_col, torch.tensor([s.rounds,
                                                      int(s.perfect)]),
                torch.tensor([s.weight], dtype=torch.float64)]
    assert digest(*out) == PARENT_SERVED[cell]


def test_lanes_follow_the_kinds_and_their_own_seeds():
    cfg = small_config("suite") | {"batch": 7}
    lanes = make_lanes(cfg, 2**31 + 3, CPU)
    assert [p.kind for p in lanes] == [KINDS[i % 5] for i in range(7)]
    assert len({p.seed for p in lanes}) == 7
    assert all(p.n == 256 and p.nnz == 2048 for p in lanes)
    again = make_lanes(cfg, 2**31 + 3, CPU)
    assert all(torch.equal(a.col, b.col) for a, b in zip(lanes, again))
    # the kinds that share powerlaw's columns still get patterns of their own
    assert not torch.equal(lanes[1].col, lanes[3].col)


@pytest.mark.parametrize("kind", KINDS)
def test_raw_values_fall_in_their_kinds_ranges(kind):
    p = make_pattern(800, 4000, kind, 5, CPU)
    v = values.raw(p, 5, 0)
    planted = p.planted[:p.nnz]
    (plo, phi), (lo, hi) = values.RANGES.get(
        kind, (values.DEFAULT, values.DEFAULT))
    assert v.dtype == torch.float64 and v.shape == (p.nnz,)
    assert bool((v[planted] >= plo).all()) and bool((v[planted] < phi).all())
    assert bool((v[~planted] >= lo).all()) and bool((v[~planted] < hi).all())
    # the draws fill their ranges
    assert float(v[~planted].min()) < lo + 0.05 * (hi - lo)
    assert float(v[~planted].max()) > hi - 0.05 * (hi - lo)


@pytest.mark.parametrize("kind", KINDS)
def test_values_are_normalised_and_perturbed_positive(kind):
    p = make_pattern(800, 4000, kind, 5, CPU)
    v = values.fresh(p, 5, 0)
    m = p.nnz
    assert v.dtype == torch.float32 and bool((v[m:] == 0).all())
    col = p.col[:m].long()
    top = torch.zeros(p.n).scatter_reduce(0, col, v[:m], "amax")
    assert torch.allclose(top, torch.ones(p.n))
    assert bool((v[:m] > 0).all()) and bool((v[:m] <= 1).all())
    w = values.perturbed(p, v, 0.02, 5, 1)
    assert bool((w[:m] >= 1e-6).all()) and not torch.equal(w, v)
    assert torch.equal(values.fresh(p, 5, 0), v)
    assert not torch.equal(values.fresh(p, 5, 1), v)


def port_answer(res):
    return (res.mate_row.long(), res.mate_col.long(), int(res.awac_iters),
            bool(res.perfect))


def ref_answer(ans):
    return ans.mate_row, ans.mate_col, ans.rounds, ans.perfect()


def same(a, b) -> bool:
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) \
        and a[2:] == b[2:]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [3, 4])
def test_reference_gives_the_ports_cold_answer(kind, seed):
    cfg = SMALL[kind]
    p = make_pattern(cfg["n"], cfg["nnz"], kind, seed, CPU)
    ref = Reference(p.row, p.col, p.n)
    for call in range(2):
        val = values.fresh(p, seed, call)
        res = api.solve(api.MatchingProblem(row=p.row, col=p.col, val=val,
                                            n=p.n))
        ans = ref.cold(val)
        assert same(port_answer(res), ref_answer(ans))
        assert ans.perfect() and ans.rounds >= 1
        assert abs(float(res.weight) - ans.weight()) <= 1e-6 * ans.weight()
        assert res.diagnosis is None
        assert preflight_issues(p.row, p.col, val, p.n) == set()


@pytest.mark.parametrize("kind", ["powerlaw", "uniform"])
def test_reference_gives_the_ports_warm_chain(kind):
    cfg = SMALL[kind]
    p = make_pattern(cfg["n"], cfg["nnz"], kind, 8, CPU)
    mix = Mix(values="perturbed", warm_start=True, warmup_calls=2,
              jitter=0.02)
    stream = Stream(mix, [p])
    ref = Reference(p.row, p.col, p.n)
    res = ans = None
    for call in range(5):
        warm = stream.warm(call)
        (val,) = stream.next()
        problem = api.MatchingProblem(row=p.row, col=p.col, val=val, n=p.n)
        if warm:
            res = api.solve(problem, warm_start=res)
            ans = ref.warm(val, ans.mate_row, ans.mate_col)
            assert res.execution.warm_started
        else:
            res = api.solve(problem)
            ans = ref.cold(val)
        assert same(port_answer(res), ref_answer(ans))


def test_repair_drops_stale_and_one_sided_pairs():
    p = make_pattern(300, 1500, "uniform", 1, CPU)
    ref = Reference(p.row, p.col, p.n)
    n = p.n
    good = ref.cold(values.fresh(p, 1, 0))
    mr, mc = good.mate_row.clone(), good.mate_col.clone()
    mr[0] = mr[1]  # column 0 claims column 1's row: one-sided
    mr[2] = n + 7  # out of range
    r, c = ref.repair(mr, mc)
    kept = (r[:n] < n)
    assert int((~kept).sum()) == 2 and not bool(kept[0]) and not bool(kept[2])
    assert torch.equal(c[r[:n][kept]], torch.arange(n)[kept])


def test_preflight_issues_finds_what_the_port_screens():
    row = torch.tensor([0, 0, 1, 3], dtype=torch.int32)
    col = torch.tensor([0, 0, 1, 3], dtype=torch.int32)
    val = torch.tensor([1.0, -2.0, float("nan"), 0.0])
    assert preflight_issues(row, col, val, 3) == {
        "duplicate_edge", "negative_weight", "nonfinite_weight",
        "empty_row", "empty_col"}


@pytest.mark.parametrize("cell", list(CELLS))
def test_lower_precision_fails_and_the_program_passes(cell):
    spec = load_spec()
    row = control.readings(spec, cell, 21, CPU,
                           config=small_config(CELLS[cell]))
    assert all(v <= LIMITS[k] for k, v in row["program"].items())
    assert any(v > LIMITS[k] for k, v in row["control"].items())
    assert row["control"]["weight_gap"] > 3 * max(
        row["program"]["weight_gap"], 1e-9)
    # the matching itself moves with the precision; a stale answer fails
    assert row["control"]["calls_off"] > 0
    assert any(v > LIMITS[k] for k, v in row["stale"].items())


@pytest.mark.parametrize("kind", ["powerlaw", "uniform"])
def test_the_answer_moves_with_the_values(kind):
    cfg = SMALL[kind]
    p = make_pattern(cfg["n"], cfg["nnz"], kind, 6, CPU)
    ref = Reference(p.row, p.col, p.n)
    a, b = (ref.cold(values.fresh(p, 6, call)) for call in (0, 1))
    moved = int((a.mate_row != b.mate_row).sum())
    assert moved > p.n // 10


@pytest.mark.parametrize("calls,warm", [(30, False), (8, False), (3, False),
                                        (30, True), (1000, False),
                                        (1000, True)])
def test_the_check_takes_the_windows_ends(calls, warm, monkeypatch):
    cell = "powerlaw_2m7.warm" if warm else "powerlaw_2m7.cold"
    seed = 2**31 + 5
    result, tally, held, solves = run_standin(monkeypatch, cell, calls, seed)
    assert result["correct"] and result["attempted"] == calls
    first = 2 if warm else 1  # after the mix's warm-up calls
    window = range(first, first + calls)
    picked = set(held.targets)
    # a warm chain's cold start, the set-up's first call, is checked too
    start = {0} if warm else set()
    assert picked <= set(window) | start
    assert {window[0], window[-1]} | start <= picked
    want = min(calls + warm, harness.CHECK_COLD_CALLS)
    assert len(picked) == want and tally.checked == want
    # the reference solves the checked calls, one a lane, and no more
    assert solves == want
    # what the window kept on the card does not grow with its calls
    assert held.most <= (2 if warm else 1) * harness.CHECK_COLD_CALLS
    assert len(held.answers) <= (2 if warm else 1) * want
    # the same seed and window pick the same calls; another seed, others
    again, other = harness.Held(seed, warm), harness.Held(seed + 1, warm)
    for k in range(first):
        again.warmed(k, [])
    for k in window:
        again.add(k, [], k == window[-1])
        other.add(k, [], k == window[-1])
    assert again.targets == held.targets
    if calls > 100:
        assert other.targets != held.targets


@pytest.mark.parametrize("cell,calls", [(BATCH_CELL, 3),
                                        ("powerlaw_2m7.warm", 20)])
def test_one_corrupt_lane_puts_its_call_off(cell, calls):
    _, cfg, mix = harness.resolve(load_spec(), cell,
                                  small_config(CELLS[cell]))
    lanes = make_lanes(cfg, 9, CPU)
    caller = harness.Caller(api, lanes, "batch" in cfg, Stream(mix, lanes),
                            CPU)
    window = range(mix.warmup_calls, mix.warmup_calls + calls)
    served = {k: caller.call() for k in range(window.stop)}
    held = control.hold(9, mix, window, served.items())
    sound = harness.check(lanes, mix, held)
    checked = min(calls, harness.CHECK_COLD_CALLS)
    assert sound.numbers() == {"calls_off": 0,
                               "weight_gap": sound.weight_gap}
    assert sound.passed() and sound.lanes == checked * len(lanes)
    # one lane of a checked call between the window's ends, swapped where
    # it was produced
    k = min(t for t in held.targets if window[0] < t < window[-1])
    b = len(lanes) // 2
    bad = served[k][b]
    mr = bad.mate_row.clone()
    mr[[0, 1]] = mr[[1, 0]]
    served[k] = served[k][:b] + [dataclasses.replace(bad, mate_row=mr)] \
        + served[k][b + 1:]
    tally = harness.check(lanes, mix, control.hold(9, mix, window,
                                                   served.items()))
    assert tally.first_off == k and not tally.passed()
    assert tally.lanes == checked * len(lanes)
    if not mix.warm_start:  # a warm call seeded by it may be off too
        assert tally.calls_off == 1
