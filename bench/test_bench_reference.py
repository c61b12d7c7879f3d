"""The benchmark's yardstick on the CPU at small sizes: the generator
hits its sizes, the plain reference gives the port's answers, and a
lower precision fails the comparison."""
from __future__ import annotations

import pytest
import torch

from bench import control, harness
from bench.gen import values
from bench.gen.pattern import make_pattern
from bench.gen.traffic import Mix, Stream
from bench.reference.awpm import Reference, preflight_issues
from bench.reference.check import LIMITS
from repro_torch.core import api

CPU = torch.device("cpu")
SMALL = {"powerlaw": dict(n=1500, nnz=7400),
         "uniform": dict(n=1200, nnz=21600)}
CELLS = {"powerlaw_2m7.cold": "powerlaw", "uniform_1m5.cold": "uniform",
         "powerlaw_2m7.warm": "powerlaw", "uniform_1m5.warm": "uniform"}


def small_config(kind: str) -> dict:
    return dict(pattern=kind, **SMALL[kind])


@pytest.mark.parametrize("kind", ["powerlaw", "uniform"])
@pytest.mark.parametrize("seed", [0, 2**31 + 99])
def test_pattern_hits_n_and_nnz(kind, seed):
    n, nnz = 5000, 5000 * 6 + 7
    p = make_pattern(n, nnz, kind, seed, CPU)
    assert p.n == n and p.nnz == nnz and p.cap % 8 == 0 and p.cap >= nnz
    row, col = p.row[:nnz].long(), p.col[:nnz].long()
    keys = row * n + col
    assert bool((keys[1:] > keys[:-1]).all())  # lex-sorted and distinct
    assert bool((p.row[nnz:] == n).all()) and bool((p.col[nnz:] == n).all())
    assert int(p.planted.sum()) == n  # the planted permutation, whole
    assert torch.equal(torch.sort(row[p.planted[:nnz]]).values,
                       torch.arange(n))
    assert torch.equal(torch.sort(col[p.planted[:nnz]]).values,
                       torch.arange(n))
    again = make_pattern(n, nnz, kind, seed, CPU)
    assert torch.equal(p.row, again.row) and torch.equal(p.col, again.col)


def test_pattern_rejects_a_count_that_cannot_fit():
    with pytest.raises(ValueError):
        make_pattern(10, 101, "uniform", 0, CPU)
    with pytest.raises(ValueError):
        make_pattern(10, 20, "banded", 0, CPU)


@pytest.mark.parametrize("kind", ["powerlaw", "uniform"])
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


@pytest.mark.parametrize("kind", ["powerlaw", "uniform"])
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
    stream = Stream(mix, p, 8)
    ref = Reference(p.row, p.col, p.n)
    res = ans = None
    for call in range(5):
        warm = stream.warm(call)
        val = stream.next()
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
    spec = harness.load_spec()
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
                                        (30, True)])
def test_the_check_takes_the_windows_ends(calls, warm):
    mix = Mix(values="perturbed" if warm else "fresh", warm_start=warm,
              warmup_calls=2)
    window = range(2, 2 + calls)
    picked = harness.check_targets(mix, 2**31 + 5, window)
    assert picked <= set(window)
    assert {window[0], window[-1]} <= picked
    want = calls if warm else min(calls, harness.CHECK_COLD_CALLS)
    assert len(picked) == want
    assert picked == harness.check_targets(mix, 2**31 + 5, window)
