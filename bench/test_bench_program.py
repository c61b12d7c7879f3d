"""The per-layer metrics that read the program's own record
(``bench/program.py`` over ``repro_torch.obs``), on the CPU: each reader
on a record made by hand, nothing where its span or counter never
opened, the split of set-up and window calls, the program's annotations
among the benchmark's spans in the trace's reading, the tracer off in an
untraced run and after loading the readers anywhere but in a traced run,
and a small traced run of every cell that reads them all."""
from __future__ import annotations

import time

import pytest
import torch

from bench import harness, peaks, program, tracing
from bench.test_bench_faults import run
from bench.test_bench_reference import CELLS, load_spec
from repro_torch import obs

NEW = ("preflight_copy_ms", "preflight_scan_ms", "greedy_rounds",
       "mcm_layers", "mcm_layer_ms", "d2h_reads", "sync_wait_ms",
       "first_solve_ms")
SPEC = load_spec()
LOADED_BY_TRACED_RUN = program._loaded_by_traced_run


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """Every test starts and ends with the tracer off and nothing taken;
    ``program.wanted`` stands in for a card, and a reader loaded by hand
    is taken as loaded by a traced run (tests that run the harness put the
    real look at the call stack back)."""
    monkeypatch.setattr(program, "wanted", lambda: True)
    monkeypatch.setattr(program, "_loaded_by_traced_run", lambda: True)
    monkeypatch.setattr(program, "_armed", False)
    monkeypatch.setattr(program, "_taken", None)
    obs.disable()
    obs.take()
    yield
    obs.disable()
    obs.take()


def record(attempted: int) -> harness.Record:
    return harness.Record(n=8, nnz=16, setup_s=1.0, window_s=1.0,
                          attempted=attempted, failed=0, rounds=[1],
                          spans={}, trace=None)


def fake_call(rounds: int, layers: int) -> None:
    """One call as the program records it: preflight, greedy rounds and
    BFS layers, each ending in a read."""
    with obs.span("solve"):
        with obs.span("preflight"):
            with obs.span("preflight.copy"):
                for _ in range(3):
                    with obs.d2h("preflight"):
                        pass
            with obs.span("preflight.scan"):
                pass
        with obs.span("greedy"):
            for _ in range(rounds):
                with obs.step("greedy.round"):
                    obs.count("greedy.rounds")
                    obs.flag(torch.tensor(True), "greedy")
        with obs.span("mcm"):
            obs.count("mcm.layers", 0)
            for _ in range(layers):
                with obs.step("mcm.layer"):
                    obs.count("mcm.layers")
                    with obs.d2h("mcm_layer"):
                        pass


def by_hand(setup=((5, 7),), window=((2, 3), (4, 5))):
    program.arm()
    for rounds, layers in setup + window:
        fake_call(rounds, layers)
    return record(len(window))


def test_the_window_is_the_last_calls():
    run_ = by_hand()
    s = program.split(run_)
    assert not obs.enabled() and s.calls == 2
    assert len(s.setup.calls()) == 1 and len(s.window.calls()) == 2
    assert s.window.count("greedy.rounds") == 6
    assert s.window.count("mcm.layers") == 8
    assert s.setup.count("mcm.layers") == 7
    assert program.split(run_) is s  # later readers read what was taken


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_the_record(name):
    reader = harness.load_reader(name)  # loaded before the calls, as run
    run_ = by_hand()
    value = reader.read(run_)
    s = program.split(run_)
    w = s.window
    want = {
        "greedy_rounds": 3.0,
        "mcm_layers": 4.0,
        "d2h_reads": (3 * 2 + 6 + 8) / 2,
        "preflight_copy_ms": sum(x.ns for x in w.named("preflight.copy"))
        / 2e6,
        "preflight_scan_ms": sum(x.ns for x in w.named("preflight.scan"))
        / 2e6,
        "mcm_layer_ms": sum(x.ns for x in w.named("mcm.layer")) / 8e6,
        "sync_wait_ms": sum(x.ns for x in w.spans
                            if x.name.startswith("d2h.")) / 2e6,
        "first_solve_ms": s.setup.calls()[0].ns / 1e6,
    }[name]
    assert value == pytest.approx(want) and value >= 0


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_nothing_where_nothing_opened(name, monkeypatch):
    reader = harness.load_reader(name)
    program.arm()
    with obs.span("solve"):  # a call whose layers never ran
        pass
    assert reader.read(record(1)) is None
    monkeypatch.setattr(program, "wanted", lambda: False)  # not armed
    program.arm()
    fake_call(2, 3)
    assert reader.read(record(1)) is None
    monkeypatch.setattr(program, "obs", None)  # a program without it
    monkeypatch.setattr(program, "_taken", None)
    program.arm()
    assert reader.read(record(1)) is None


@pytest.mark.parametrize("kernel_calls", [2, 0])
def test_mcm_roofline_reads_the_kernels_share(kernel_calls):
    reader = harness.load_reader("mcm_roofline")
    program.arm()
    for call in range(3):
        with obs.span("solve"):
            with obs.span("mcm"):
                obs.count("mcm.kernel", int(call < kernel_calls))
                obs.count("mcm.phases", 10 + call)
                obs.count("mcm.layers", 100 + call)
    run_ = record(3)
    run_.n, run_.nnz = 4096, 32768
    run_.trace = tracing.DeviceTrace(
        window_s=1.0, busy_s=0.5, gaps={},
        rows={"void (anonymous namespace)::mcm_kernel(Params)": (2, 2e-4),
              "awac_loop_kernel": (3, 1.0)})
    got = reader.read(run_)
    if not kernel_calls:  # no call ran the kernel: nothing to share
        assert got is None
        return
    nbytes, ops = peaks.mcm_bytes(32768, 4096, 10 + 11, 100 + 101, 2)
    assert nbytes == 8 * 32768 * 21 + 8 * 128 * 201 + 16 * 4097 * 2
    assert got == pytest.approx(100 * nbytes / peaks.HBM_BYTES_PER_S / 2e-4)
    assert 0 < got < 100
    run_.trace.rows.pop("void (anonymous namespace)::mcm_kernel(Params)")
    assert reader.read(run_) is None  # no launch in the trace


def test_innermost_span_of_either_kind_wins():
    spans = sorted([
        ("solve", 0, 100), ("repro_torch.solve", 1, 99),
        ("warm_state", 10, 90), ("repro_torch.warm_state", 11, 89),
        ("repro_torch.warm.topup", 20, 30),
        ("repro_torch.mcm", 25, 30),
    ], key=lambda t: (t[1], -t[2]))
    labels = tracing._labels([5, 15, 22, 27, 50, 95, 99.5], spans)
    assert labels == ["repro_torch.solve", "repro_torch.warm_state",
                      "repro_torch.warm.topup", "repro_torch.mcm",
                      "repro_torch.warm_state", "repro_torch.solve", "solve"]


def test_the_trace_reads_program_annotations_as_spans():
    spans = tracing.Spans(torch.device("cpu"))
    obs.enable(annotate=program.ANNOTATE)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.PREFIX + "window"):
            with spans.span("solve"):
                with obs.span("solve"):
                    with obs.span("mcm"):
                        with obs.step("mcm.layer"):
                            with obs.d2h("mcm_layer"):
                                time.sleep(0.05)
    obs.disable()
    t = tracing.read(prof)
    # no device event on the CPU: the window is one gap, at its middle the
    # program's innermost annotated span (a step and a read are not
    # annotations)
    assert list(t.gaps) == ["repro_torch.mcm"]
    assert t.rows == {} and t.busy_s == 0


def test_loading_the_readers_elsewhere_leaves_the_tracer_off(monkeypatch):
    monkeypatch.setattr(program, "_loaded_by_traced_run",
                        LOADED_BY_TRACED_RUN)
    for name in NEW:
        harness.load_reader(name)
    assert not obs.enabled() and not program._armed


def test_the_untraced_run_leaves_the_tracer_off(monkeypatch):
    monkeypatch.setattr(program, "_loaded_by_traced_run",
                        LOADED_BY_TRACED_RUN)
    run("powerlaw_2m7.cold", traced=True)
    assert not obs.enabled()
    result = run("powerlaw_2m7.cold", traced=False)
    assert not obs.enabled() and obs.take().spans == []
    assert set(result["metrics"]) == {"solve_ms", "setup_s"}


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_traced_run_reads_the_programs_record(cell, monkeypatch):
    monkeypatch.setattr(program, "_loaded_by_traced_run",
                        LOADED_BY_TRACED_RUN)
    result = run(cell, traced=True)
    assert result["correct"] and not obs.enabled()
    got = {k: v["value"] for k, v in result["metrics"].items()}
    want = {m["name"] for m in harness.metrics_of(SPEC, cell, True)} & set(
        NEW)
    assert want <= set(got)
    assert got["d2h_reads"] >= 4  # three preflight copies and the finish
    assert got["preflight_copy_ms"] + got["preflight_scan_ms"] \
        <= got["preflight_ms"]
    if cell.endswith("cold"):
        assert got["greedy_rounds"] >= 1 and got["mcm_layers"] >= 1
        assert got["d2h_reads"] >= got["greedy_rounds"] + got["mcm_layers"]
    if "mcm_layer_ms" in want:  # the batched engine's host layers
        assert got["mcm_layers"] * got["mcm_layer_ms"] \
            <= got["mcm_ms"] * (1 + 1e-9)
