"""The port's paper-evaluation runner (``repro_torch.experiments``) against
the JAX package's ``experiments/paper_eval.py`` on ``QUICK_SPEC``: the six
fixtures and three synthetic matrices through every local backend,
"auto", the 1x1 grid and the 2x2 grid, which the port runs over 4 spawned
gloo ranks and the JAX child on 4 fake devices (so its ``_eval_grid``
runs in process).

Engines map reference <-> reference, torch <-> xla, cuda <-> pallas,
cuda_persistent <-> pallas_persistent, and auto, grid1x1 and grid2x2 to
themselves. Per row, ``weight``, ``upper_bound``, ``ratio_bound`` and
``ratio_exact`` agree to rtol 1e-6 (float32 sums in other orders), and
``awac_iters``, ``tight``, ``perfect``, ``identical_to_reference`` and
``certified_sound`` are equal. The rest ports the JAX package's
``tests/test_paper_eval.py``.
"""
import concurrent.futures
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.experiments import __main__ as cli  # noqa: E402
from repro_torch.experiments import paper_eval  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

ENGINES = {"reference": "reference", "torch": "xla", "cuda": "pallas",
           "cuda_persistent": "pallas_persistent", "auto": "auto",
           "grid1x1": "grid1x1", "grid2x2": "grid2x2"}
FLOATS = ("weight", "upper_bound", "ratio_bound", "ratio_exact")
EXACT = ("awac_iters", "tight", "perfect", "identical_to_reference",
         "certified_sound", "n", "nnz")
GRIDS = [(1, 1), (2, 2)]


# the JAX sweep in four children run side by side: each interpreted
# Pallas backend, the other backends with the 1x1 grid, and the 2x2 grid
# on 4 fake devices
JAX_PARTS = ((("pallas",), [], 1), (("pallas_persistent",), [], 1),
             (("reference", "xla", "auto"), [(1, 1)], 1),
             ((), [(2, 2)], 4))
JAX_BODY = """
    from repro.experiments import paper_eval as pe
    recs = pe.run_eval(pe.QUICK_SPEC, backends=tuple(IN["backends"].tolist()),
                       grids=[tuple(g) for g in IN["grids"].tolist()])
    nan = float("nan")
    OUT["name"] = np.array([r.name for r in recs])
    OUT["engine"] = np.array([r.engine for r in recs])
    for k in ("weight", "upper_bound", "ratio_bound", "ratio_exact"):
        OUT[k] = np.array([nan if getattr(r, k) is None
                           else getattr(r, k) for r in recs])
    for k in ("awac_iters", "tight", "perfect", "identical_to_reference",
              "certified_sound", "n", "nnz"):
        OUT[k] = np.array([getattr(r, k) for r in recs])
"""


@pytest.fixture(scope="module")
def jax_futures(tmp_path_factory):
    """The JAX children, started before the port's sweep so that both run
    at once."""
    pool = concurrent.futures.ThreadPoolExecutor(len(JAX_PARTS))
    futures = []
    for i, (backends, grids, n_devices) in enumerate(JAX_PARTS):
        inputs = {"backends": np.array(backends),
                  "grids": np.array(grids, np.int64).reshape(-1, 2)}
        futures.append(pool.submit(
            run_reference, JAX_BODY, inputs,
            tmp_path_factory.mktemp(f"paper_eval_ref{i}"), n_devices))
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def records(jax_futures):
    return paper_eval.run_eval(paper_eval.QUICK_SPEC,
                               backends=paper_eval.DEFAULT_BACKENDS,
                               grids=GRIDS, device="cpu")


@pytest.fixture(scope="module")
def jax_records(jax_futures):
    rows = {}
    for fut in jax_futures:
        out = fut.result()
        for i, (name, engine) in enumerate(zip(out["name"], out["engine"])):
            rows[(str(name), str(engine))] = {
                k: out[k][i] for k in out if k not in ("name", "engine")}
    return rows


def test_every_row_equals_jax(records, jax_records):
    assert len(records) == len(jax_records)
    for r in records:
        want = jax_records[(r.name, ENGINES[r.engine])]
        for k in FLOATS:
            got = getattr(r, k)
            got = float("nan") if got is None else got
            np.testing.assert_allclose(got, want[k], rtol=1e-6,
                                       err_msg=f"{r.name} [{r.engine}] {k}")
        for k in EXACT:
            assert getattr(r, k) == want[k].item(), (r.name, r.engine, k)


def test_sweep_shape(records):
    cases = paper_eval._cases_from_spec(paper_eval.QUICK_SPEC, device="cpu")
    # per case: the four backends, "auto" and the two grid rows
    assert len(records) == 7 * len(cases)
    assert {r.engine for r in records} == set(ENGINES)
    assert {r.source for r in records} == {"fixture", "synthetic"}
    assert {r.device for r in records} == {"cpu"}


def test_every_row_checked(records):
    for r in records:
        assert r.perfect
        assert r.certified_sound
        assert r.identical_to_reference
        assert r.weight <= r.upper_bound + 1e-6 * max(1.0, abs(r.upper_bound))
        assert r.wall_s > 0


def test_auto_row_records_how_it_was_chosen(records):
    from repro_torch.core.single import resolve_auto

    for r in records:
        if r.engine == "auto":
            assert (r.backend, r.dispatch) == resolve_auto("cpu", n=r.n)
        elif r.engine.startswith("grid"):
            assert (r.backend, r.dispatch) == ("fused", "grid-default")
        else:
            assert (r.backend, r.dispatch) == (r.engine, "explicit")


def test_fixture_bounds_match_oracle(records):
    for r in records:
        if r.ratio_exact is not None and r.ratio_bound is not None:
            assert r.ratio_bound <= r.ratio_exact + 1e-6


def test_log_scaled_fixture_bit_identical_across_backends(records):
    rows = {r.engine: r for r in records if r.name == "circuit8"}
    assert rows["reference"].transform == "log2_scaled_nonneg"
    for engine in ENGINES:
        assert rows[engine].weight == rows["reference"].weight, engine
        assert rows[engine].awac_iters == rows["reference"].awac_iters
        assert rows[engine].identical_to_reference


def test_bench_rows_carry_gate_flags(records):
    rows = paper_eval.to_bench_rows(records)
    assert len(rows) == len(records)
    assert all(r["name"].startswith("paper_eval_") for r in rows)
    for r in rows:
        flags = dict(kv.split("=", 1) for kv in r["derived"].split(";"))
        assert flags["certified_sound"] == "True"
        assert flags["identical_to_reference"] == "True"
        assert r["us_per_call"] > 0
        if r["name"].endswith("_auto"):
            assert flags["dispatch"] in ("table", "heuristic")


def test_identity_flag_is_a_real_comparison_without_reference_backend():
    # identical_to_reference comes from an actual reference solve even
    # when "reference" is not among the swept backends
    spec = {"fixtures": True, "synthetic_count": 0, "names": ["circuit8"]}
    (r,) = paper_eval.run_eval(spec, backends=("torch",), grids=[],
                               device="cpu")
    assert r.engine == "torch" and r.identical_to_reference


def test_divergent_backend_raises(monkeypatch):
    # a backend whose matching differs from "reference" is caught
    spec = {"fixtures": True, "synthetic_count": 0, "names": ["circuit8"]}
    real = paper_eval._case_aux

    def wrong_reference(case, oracle_max_n):
        opt, mate = real(case, oracle_max_n)
        return opt, np.roll(mate[:-1], 1).tolist() + [mate[-1]]

    monkeypatch.setattr(paper_eval, "_case_aux", wrong_reference)
    with pytest.raises(AssertionError, match="differs from the reference"):
        paper_eval.run_eval(spec, backends=("torch",), grids=[],
                            device="cpu")


def test_markdown_table(records):
    md = paper_eval.to_markdown(records)
    header = [ln for ln in md.splitlines() if ln.startswith("| matrix")][0]
    assert header.count("|") == md.splitlines()[-1].count("|")
    assert "circuit8" in md and "grid1x1" in md and "grid2x2" in md
    assert "| auto (" in md


def test_write_outputs(tmp_path, records):
    table, bench = paper_eval.write_outputs(
        records, 1.0, out_dir=tmp_path, quick=True, device="cpu")
    assert table.parent == tmp_path and bench.name == "paper_eval.json"
    rec = json.loads(bench.read_text())
    assert rec["suite"] == "paper_eval"
    assert len(rec["rows"]) == len(rec["records"]) == len(records)
    assert rec["metadata"]["quick"] is True
    assert rec["metadata"]["device"] == "cpu" and rec["metadata"]["cpu"]
    back = [paper_eval.EvalRecord(**r) for r in rec["records"]]
    assert back == list(records)
    assert table.read_text().startswith("# Paper evaluation")


def test_default_outputs_are_the_ports_own():
    root = paper_eval.REPO_ROOT
    assert paper_eval.DEFAULT_OUT_DIR == root / "results" / "torch"


def test_unsound_or_divergent_rows_raise():
    rec = paper_eval.EvalRecord(
        name="x", source="fixture", transform="abs", engine="torch", n=4,
        nnz=4, weight=1.0, upper_bound=0.5, ratio_bound=1.0,
        ratio_exact=None, tight=False, awac_iters=1, wall_s=0.0,
        perfect=True, identical_to_reference=True, certified_sound=False)
    with pytest.raises(AssertionError, match="UNSOUND"):
        paper_eval._check(rec)
    rec2 = dataclasses.replace(rec, certified_sound=True,
                               identical_to_reference=False)
    with pytest.raises(AssertionError, match="differs from the reference"):
        paper_eval._check(rec2)
    rec3 = dataclasses.replace(rec, certified_sound=True, perfect=False)
    with pytest.raises(AssertionError, match="not perfect"):
        paper_eval._check(rec3)


def test_grid_rows_come_back_typed_and_checked(records):
    rows = [r for r in records if r.engine == "grid2x2"]
    assert len(rows) == len(records) // 7
    r = next(r for r in rows if r.name == "circuit8")
    assert isinstance(r, paper_eval.EvalRecord)
    assert r.identical_to_reference and r.certified_sound and r.perfect
    assert np.isclose(r.ratio_bound, 1.0)


def test_larger_grid_on_the_card_is_refused():
    with pytest.raises(ValueError, match="needs 4 cards"):
        paper_eval._eval_grid([], {}, (2, 2), 64, {}, torch.device("cuda"))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run_eval would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_eval.run_eval(paper_eval.QUICK_SPEC, backends=("torch",),
                            grids=[])


def test_cli_quick_on_the_cpu(tmp_path, capsys):
    cli.main(["--device", "cpu", "--quick", "--suite-count", "1",
              "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "rows on cpu" in out and "min certified ratio bound" in out
    rec = json.loads((tmp_path / "paper_eval.json").read_text())
    # 6 fixtures + 1 synthetic matrix, reference and torch and the 1x1 grid
    assert len(rec["rows"]) == 7 * 3
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--grids", "2by2"])


# ------------------------------- on the card -------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel backends launch CUDA "
                    "C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.gpu
def test_run_eval_on_the_card_equals_the_cpu(cuda):
    import torch.distributed as tdist

    cpu = {(r.name, r.engine): r for r in paper_eval.run_eval(
        paper_eval.QUICK_SPEC, backends=paper_eval.DEFAULT_BACKENDS,
        grids=[], device="cpu")}
    if tdist.is_initialized() and tdist.get_backend() != "nccl":
        tdist.destroy_process_group()  # a CPU test's one-rank gloo grid
    on_card = paper_eval.run_eval(paper_eval.QUICK_SPEC,
                                  backends=paper_eval.DEFAULT_BACKENDS,
                                  grids=[(1, 1)])
    assert len(on_card) == 6 * len(cpu) // 5
    for r in on_card:
        # the grid row against the CPU's reference row: all are identical
        want = cpu[(r.name, "reference" if r.engine == "grid1x1"
                    else r.engine)]
        assert r.device.startswith("cuda")
        for k in ("weight", "upper_bound", "ratio_bound", "ratio_exact"):
            a, b = getattr(r, k), getattr(want, k)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=1e-6)
        for k in EXACT:
            assert getattr(r, k) == getattr(want, k), (r.name, r.engine, k)
