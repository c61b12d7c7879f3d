"""A whole run of each cell on the CPU at a small size, the look for a
card skipped: sound, it comes out correct; with the timed path broken
underneath, it comes out not correct."""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from bench import harness
from bench.test_bench_reference import (BATCH_CELL, CELLS, StandIn,
                                        load_spec, small_config)
from repro_torch.core import api, batch, single

CPU = torch.device("cpu")
SECONDS = 0.3
WARM_CELLS = [c for c in CELLS if c.endswith(".warm")]
#: the first window call of a warm mix, after its warm-up calls
WARM_FIRST = harness.resolve(load_spec(), WARM_CELLS[0], {})[2].warmup_calls


def run_cell(cell: str, seed: int = 5, traced: bool = False):
    return harness.run_cell(load_spec(), cell, seed, SECONDS, traced,
                            CPU, time.perf_counter(),
                            config=small_config(CELLS[cell]))


def run(cell: str, seed: int = 5, traced: bool = False):
    return run_cell(cell, seed, traced)[0]


def unchanged_state(monkeypatch):
    """Each engine hands back the state of its first call (a set-up call)
    on every later call: the step leaves its state unchanged."""
    for module, name in ((single, "_awpm"), (batch, "_awpm_batched"),
                         (batch, "_awpm_batched_from_state")):
        real, held = getattr(module, name), []

        def engine(*args, _real=real, _held=held, **kwargs):
            if not _held:
                _held.append(_real(*args, **kwargs))
            return _held[0]

        monkeypatch.setattr(module, name, engine)


def swapped(out):
    """``out`` with two columns' rows swapped, in every lane."""
    mr = out.mate_row.clone()
    mr[..., [0, 1]] = mr[..., [1, 0]]
    return dataclasses.replace(out, mate_row=mr)


def altered_answer(monkeypatch):
    """The answer swaps two columns' rows where it is produced."""
    real = api._result
    monkeypatch.setattr(api, "_result",
                        lambda *args, **kwargs: swapped(real(*args, **kwargs)))


def half_the_batch(monkeypatch):
    """The batched engine solves the first half of the lanes only and
    answers each lane of the second half with a solved lane's answer."""
    real = batch._awpm_batched

    def engine(row, col, val, n, **kwargs):
        b = row.shape[0]
        h = max(b // 2, 1)
        state, iters = real(row[:h], col[:h], val[:h], n, **kwargs)
        idx = torch.arange(b, device=row.device) % h
        return type(state)(*(x[idx] for x in state)), iters[idx]

    monkeypatch.setattr(batch, "_awpm_batched", engine)


def wrong_at_a_checked_step(monkeypatch):
    """A stand-in program answers the reference's answer, but for the
    window's first call, a checked one, where two columns swap rows (and
    the next call is seeded from it)."""
    program = StandIn(alter=lambda call, out: swapped(out)
                      if call == WARM_FIRST else out)
    monkeypatch.setattr(api, "solve", program.solve)


def stale_answer(monkeypatch):
    """A stand-in program answers every call with its first answer."""
    first = []

    def alter(call, out):
        first.append(out)
        return first[0]

    monkeypatch.setattr(api, "solve", StandIn(alter=alter).solve)


def bfloat16_answer(monkeypatch):
    """A stand-in program answers with the reference computed in
    bfloat16, each warm call seeded with its own previous answer."""
    monkeypatch.setattr(api, "solve", StandIn(dtype=torch.bfloat16).solve)


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_is_correct(cell, traced):
    result, tally = run_cell(cell, traced=traced)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    lanes = small_config(CELLS[cell]).get("batch", 1)
    assert tally.checked >= 1 and tally.lanes == lanes * tally.checked
    engine = {"greedy_ms", "mcm_ms"} if cell.endswith("cold") else {
        "warm_state_ms"}
    want = {"solve_ms", "setup_s"} if not traced else (
        {"preflight_ms", "awac_ms", "awac_rounds"} | engine)
    assert set(result["metrics"]) == want
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


FAULTS = [(c, f) for f in (altered_answer, unchanged_state)
          for c in CELLS] + [(BATCH_CELL, half_the_batch)] + [
    (c, f) for f in (wrong_at_a_checked_step, stale_answer, bfloat16_answer)
    for c in WARM_CELLS]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{f.__name__}-{c}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run(cell)
    assert not result["correct"]
    assert result["failed"] > 0 or any(
        v["value"] > v["limit"] for v in result["checks"].values())


@pytest.mark.parametrize("cell", ["powerlaw_2m7.cold", "uniform_1m5.cold"])
def test_calls_that_raise_are_failed(cell, monkeypatch):
    spec = load_spec()
    cfg = small_config(CELLS[cell])
    real = single._awpm
    calls = {"n": 0}

    def engine(*args, **kwargs):  # the warm-up call passes, then all raise
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("broken engine")
        return real(*args, **kwargs)

    monkeypatch.setattr(single, "_awpm", engine)
    result, tally = harness.run_cell(spec, cell, 5, SECONDS, False, CPU,
                                     time.perf_counter(), config=cfg)
    assert not result["correct"]
    assert result["failed"] == result["attempted"] >= 1
    assert "solve_ms" not in result["metrics"]
