"""The benchmark's runs on the card at a test's size: each cell's run
comes out correct through the kernels, its traced run reads every
per-layer metric, and the control fails. Skipped without a card."""
from __future__ import annotations

import time

import pytest
import torch

from bench import control, harness
from bench.reference.check import LIMITS
from bench.test_bench_reference import CELLS, load_spec, small_config

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_traced_run_on_the_card(cell, card):
    spec = load_spec()
    result, _ = harness.run_cell(spec, cell, 31, 1.0, True, card,
                                 time.perf_counter(),
                                 config=small_config(CELLS[cell]))
    assert result["correct"], result["checks"]
    want = {m["name"] for m in harness.metrics_of(spec, cell, True)}
    assert set(result["metrics"]) == want
    for name in {"k2_roofline", "mcm_roofline"} & want:
        assert 0 < result["metrics"][name]["value"] <= 100, name
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_fails_on_the_card(cell, card):
    row = control.readings(load_spec(), cell, 32, card,
                           config=small_config(CELLS[cell]))
    assert all(v <= LIMITS[k] for k, v in row["program"].items())
    assert any(v > LIMITS[k] for k, v in row["control"].items())
