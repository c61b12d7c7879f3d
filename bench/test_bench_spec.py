"""``BENCHMARK.json`` against the rules the harness is built to: every
name is found as a file, every metric has a reader, every cell reports
what it must, and the shapes of names, units and bounds are kept."""
from __future__ import annotations

import json
import re

import pytest

from bench import harness
from bench.gen.pattern import KINDS
from bench.gen.traffic import Mix

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"][1].startswith("bench/")
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_and_units():
    names = [m["name"] for m in METRICS] + [c["name"] for c in
                                            SPEC["configs"]] + [
        w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names)
    for name in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    reader = harness.load_reader(metric["name"])
    assert callable(reader.read)
    for module, attr in getattr(reader, "WRAPS", ()):
        assert module.startswith("repro_torch.") and attr


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_every_cell_resolves_and_reports(cell):
    _, config, mix = harness.resolve(SPEC, cell["name"])
    assert isinstance(mix, Mix) and cell["chips"] in (1, 4)
    assert config["nnz"] >= config["n"] > 0
    kinds = config["kinds"] if "batch" in config else [config["pattern"]]
    assert kinds and set(kinds) <= set(KINDS)
    assert int(config.get("batch", 1)) >= 1
    e2e = {m["name"] for m in harness.metrics_of(SPEC, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.metrics_of(SPEC, cell["name"], True)
    assert layer and all(m["moves"] in e2e for m in layer)


def test_config_files_hold_their_sources():
    for c in SPEC["configs"]:
        with open(harness.ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert set(c["reduced"]) <= set(body)


def test_per_layer_metrics_list_their_cells():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
