"""Out-of-tree Matrix Market cases in the port's evaluation runner (the
spec's ``extra_mtx``, the CLI's ``--download``/``--instances``/
``--cache-dir``) against the JAX package's, on the CPU, with no network.

The files are fixtures of ``tests/data`` copied under their own stems
(``count4_int``: integers through ``abs``; ``mesh5_pat``: a pattern file)
and under a stem no table knows (``stand_in``, a copy of ``zcoil7``), which
must get the paper's metric, ``log2_scaled_nonneg``. They are stand-ins
for the paper's SuiteSparse instances, which are not in the repository.

  - ``run_eval`` with ``extra_mtx`` and two suite matrices of n = 48:
    the port's "reference", "torch", "auto", the 1x1 grid and the 2x2 grid
    over 4 spawned gloo ranks, against JAX's "reference", "xla", "auto"
    and both grids (the 2x2 on 4 fake devices) in one child. Row by row,
    in order: ``name``, ``source``, ``transform``, ``awac_iters``,
    ``tight``, ``perfect``, ``identical_to_reference``,
    ``certified_sound``, ``n`` and ``nnz`` equal; ``weight``,
    ``upper_bound``, ``ratio_bound`` and ``ratio_exact`` to rtol 1e-6
    (float32 sums in other orders).
  - the CLI: ``--instances`` without ``--download`` and ``--download``
    with every instance unreachable end as JAX's CLI ends (run in the same
    child); ``--download`` over ``file://`` tarballs (``BASE_URL``
    patched, as ``test_torch_suitesparse.py`` does) sweeps the instances
    with ``source="suitesparse"``, and a cache filled beforehand (by that
    download, or by hand) gives the same rows with the URL gone.
"""
import concurrent.futures
import json
import shutil
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import suitesparse as port_ss  # noqa: E402
from repro_torch.experiments import __main__ as cli  # noqa: E402
from repro_torch.experiments import paper_eval  # noqa: E402
from test_torch_harness import REPO, run_reference  # noqa: E402

DATA = REPO / "tests" / "data"
#: the swept file's stem -> the fixture it copies
FILES = {"count4_int": "count4_int", "mesh5_pat": "mesh5_pat",
         "stand_in": "zcoil7"}
TRANSFORMS = {"count4_int": "abs", "mesh5_pat": "pattern",
              "stand_in": "log2_scaled_nonneg"}
SPEC = {"fixtures": False, "synthetic_count": 2, "synthetic_n": 48}
BACKENDS = ("reference", "torch", "auto")
GRIDS = [(1, 1), (2, 2)]
ENGINES = {"reference": "reference", "torch": "xla", "auto": "auto",
           "grid1x1": "grid1x1", "grid2x2": "grid2x2"}
FLOATS = ("weight", "upper_bound", "ratio_bound", "ratio_exact")
EXACT = ("awac_iters", "tight", "perfect", "identical_to_reference",
         "certified_sound", "n", "nnz")
LABELS = ("name", "engine", "source", "transform")
GROUP = "Synthetic"
INSTANCES = ",".join(f"{GROUP}/{stem}" for stem in FILES)
#: the CLI's sweep in the tests: fixtures and the instances, "reference"
#: and "torch", the 1x1 grid, no suite matrices, nothing written
CLI_SWEEP = ["--device", "cpu", "--quick", "--suite-count", "0",
             "--no-persist"]

JAX_BODY = """
    import json
    import runpy
    import sys

    from repro.data import suitesparse as ss
    from repro.experiments import paper_eval as pe

    recs = pe.run_eval(json.loads(str(IN["spec"])),
                       backends=("reference", "xla", "auto"),
                       grids=[(1, 1), (2, 2)])
    nan = float("nan")
    for k in ("name", "engine", "source", "transform"):
        OUT[k] = np.array([getattr(r, k) for r in recs])
    for k in ("weight", "upper_bound", "ratio_bound", "ratio_exact"):
        OUT[k] = np.array([nan if getattr(r, k) is None
                           else getattr(r, k) for r in recs])
    for k in ("awac_iters", "tight", "perfect", "identical_to_reference",
              "certified_sound", "n", "nnz"):
        OUT[k] = np.array([getattr(r, k) for r in recs])

    def cli(argv):
        sys.argv = ["run_paper_eval.py"] + argv
        try:
            runpy.run_path(str(IN["cli"]), run_name="__main__")
        except SystemExit as e:
            return ["SystemExit", str(e.code)]
        except Exception as e:
            return [type(e).__name__, str(e)]
        return ["ok", ""]

    OUT["no_download"] = json.dumps(cli(["--instances", str(IN["instances"])]))
    ss.BASE_URL = "file://" + str(IN["gone"])
    OUT["unreachable"] = json.dumps(cli(
        ["--download", "--instances", str(IN["instances"]),
         "--cache-dir", str(IN["cache"])]))
"""


def _place(root):
    """The swept files under ``root``, sorted as the CLI sorts them."""
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for stem, fixture in FILES.items():
        shutil.copyfile(DATA / f"{fixture}.mtx", root / f"{stem}.mtx")
        paths.append(str(root / f"{stem}.mtx"))
    return sorted(paths)


def _serve(root):
    """Each file as the collection serves it: ``<Group>/<name>.tar.gz``
    holding ``<name>/<name>.mtx``."""
    (root / GROUP).mkdir(parents=True, exist_ok=True)
    for stem, fixture in FILES.items():
        with tarfile.open(root / GROUP / f"{stem}.tar.gz", "w:gz") as tf:
            tf.add(DATA / f"{fixture}.mtx", arcname=f"{stem}/{stem}.mtx")
    return root


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _place(tmp_path_factory.mktemp("instances"))


@pytest.fixture(scope="module")
def jax_future(files, tmp_path_factory):
    """The JAX child, started before the port's sweep so that both run at
    once."""
    work = tmp_path_factory.mktemp("paper_instances_ref")
    inputs = {"spec": np.array(json.dumps({**SPEC, "extra_mtx": files})),
              "cli": np.array(str(REPO / "experiments" /
                                  "run_paper_eval.py")),
              "instances": np.array(INSTANCES),
              "gone": np.array(str(work / "gone")),
              "cache": np.array(str(work / "cache"))}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_reference, JAX_BODY, inputs, work, 4)
    yield fut, work
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def records(files, jax_future):
    return paper_eval.run_eval({**SPEC, "extra_mtx": files},
                               backends=BACKENDS, grids=GRIDS, device="cpu")


@pytest.fixture(scope="module")
def jax_out(jax_future):
    fut, work = jax_future
    return fut.result(), work


def test_every_row_equals_jax(records, jax_out):
    want, _ = jax_out
    assert len(records) == len(want["name"])
    for i, r in enumerate(records):
        got = (r.name, ENGINES[r.engine], r.source, r.transform)
        assert got == tuple(str(want[k][i]) for k in LABELS), i
        for k in FLOATS:
            x = getattr(r, k)
            np.testing.assert_allclose(
                float("nan") if x is None else x, want[k][i], rtol=1e-6,
                err_msg=f"{r.name} [{r.engine}] {k}")
        for k in EXACT:
            assert getattr(r, k) == want[k][i].item(), (r.name, r.engine, k)


def test_cases_and_order(files):
    cases = paper_eval._cases_from_spec({**SPEC, "extra_mtx": files},
                                        device="cpu")
    # the files after the (absent) fixtures, before the suite matrices
    assert [c.source for c in cases] == ["suitesparse"] * 3 + \
        ["synthetic"] * 2
    assert {c.name: c.transform for c in cases[:3]} == TRANSFORMS
    with_fixtures = paper_eval._cases_from_spec(
        {**SPEC, "fixtures": True, "extra_mtx": files,
         "names": ["stand_in", "zcoil7"]}, device="cpu")
    assert [(c.name, c.source) for c in with_fixtures] == \
        [("zcoil7", "fixture"), ("stand_in", "suitesparse")]
    assert with_fixtures[0].nnz == with_fixtures[1].nnz


def test_extra_mtx_cases_contract(files, tmp_path):
    cases = paper_eval.extra_mtx_cases(files, device="cpu")
    assert [c.name for c in cases] == sorted(FILES)
    fixture = {c.name: c for c in paper_eval.fixture_cases(device="cpu")}
    for c in cases:
        assert c.source == "suitesparse"
        assert c.transform == TRANSFORMS[c.name]
        assert c.problem.row.device.type == "cpu"
        twin = fixture[FILES[c.name]]
        assert c.nnz == twin.nnz
        assert torch.equal(c.problem.val, twin.problem.val)
    # a fixture the runner reads through ``abs``, under an unknown stem, is
    # read in the paper's metric
    shutil.copyfile(DATA / "count4_int.mtx", tmp_path / "renamed.mtx")
    (c,) = paper_eval.extra_mtx_cases([tmp_path / "renamed.mtx"],
                                      device="cpu")
    assert c.transform == "log2_scaled_nonneg"
    assert not torch.equal(c.problem.val, fixture["count4_int"].problem.val)


def test_sweep_rows(records, files):
    # per case: three backends and two grid rows
    assert len(records) == 5 * 5
    assert {r.engine for r in records} == set(ENGINES)
    assert {r.device for r in records} == {"cpu"}
    for r in records:
        assert r.perfect and r.certified_sound and r.identical_to_reference
    rows = paper_eval.to_bench_rows(records)
    assert any(r["name"] == "paper_eval_stand_in_grid2x2" for r in rows)
    assert "| stand_in | suitesparse | log2_scaled_nonneg | grid2x2 |" in \
        paper_eval.to_markdown(records)


def test_write_outputs_carry_the_rows(records, tmp_path):
    _, bench = paper_eval.write_outputs(records, 1.0, out_dir=tmp_path,
                                        device="cpu")
    back = [paper_eval.EvalRecord(**r)
            for r in json.loads(bench.read_text())["records"]]
    assert back == list(records)
    assert {r.source for r in back} == {"suitesparse", "synthetic"}


# ---------------------------------- the CLI ----------------------------------


def test_instances_need_download_as_in_jax(jax_out):
    want, _ = jax_out
    with pytest.raises(SystemExit) as e:
        cli.main(["--instances", INSTANCES])
    assert ["SystemExit", str(e.value.code)] == \
        json.loads(str(want["no_download"]))
    assert "--instances needs --download" in str(e.value.code)


def test_every_instance_unreachable_raises_as_in_jax(jax_out, tmp_path,
                                                     monkeypatch):
    want, work = jax_out
    monkeypatch.setattr(port_ss, "BASE_URL", f"file://{work / 'gone'}")

    def no_sweep(*a, **k):
        raise AssertionError("the sweep ran")

    monkeypatch.setattr(paper_eval, "run_eval", no_sweep)
    with pytest.raises(port_ss.SuiteSparseUnavailable) as e:
        cli.main(CLI_SWEEP + ["--download", "--instances", INSTANCES,
                              "--cache-dir", str(tmp_path / "cache")])
    got = str(e.value).replace(str(tmp_path / "cache"), "<cache>")
    kind, msg = json.loads(str(want["unreachable"]))
    assert kind == "SuiteSparseUnavailable"
    assert got == msg.replace(str(work / "cache"), "<cache>")
    assert got.startswith("every SuiteSparse fetch failed")


def _untimed(records):
    return [{k: v for k, v in vars(r).items() if k != "wall_s"}
            for r in records]


@pytest.fixture(scope="module")
def downloaded(tmp_path_factory):
    """The CLI's ``--download`` over ``file://`` tarballs into a new
    cache, then over that cache with the URL gone: (rows, rows again,
    printed lines, the cache)."""
    serve = _serve(tmp_path_factory.mktemp("serve"))
    cache = tmp_path_factory.mktemp("cache")
    argv = CLI_SWEEP + ["--download", "--instances", INSTANCES,
                        "--cache-dir", str(cache)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ss, "BASE_URL", f"file://{serve}")
        first = cli.main(argv)
        mp.setattr(port_ss, "BASE_URL", f"file://{serve / 'gone'}")
        again = cli.main(argv)
    return first, again, cache


def test_download_sweeps_the_instances(downloaded):
    first, _, cache = downloaded
    rows = [r for r in first if r.source == "suitesparse"]
    # reference, torch and the 1x1 grid for each instance
    assert len(rows) == 3 * len(FILES)
    assert {r.name: r.transform for r in rows} == TRANSFORMS
    assert {r.engine for r in rows} == {"reference", "torch", "grid1x1"}
    assert {r.source for r in first} == {"fixture", "suitesparse"}
    for stem in FILES:
        assert (cache / GROUP / stem / f"{stem}.mtx").read_bytes() == \
            (DATA / f"{FILES[stem]}.mtx").read_bytes()
    pins = json.loads((cache / "checksums.json").read_text())
    assert sorted(pins) == sorted(f"{GROUP}/{s}" for s in FILES)


def test_download_rows_equal_run_eval(downloaded, records):
    first, _, _ = downloaded
    direct = {(r.name, r.engine): r for r in records}
    for r in first:
        if r.source != "suitesparse":
            continue
        want = direct[(r.name, r.engine)]
        for k in FLOATS + EXACT + ("transform",):
            assert getattr(r, k) == getattr(want, k), (r.name, r.engine, k)


def test_filled_cache_needs_no_network(downloaded):
    first, again, _ = downloaded
    assert _untimed(again) == _untimed(first)


def test_cache_filled_by_hand_needs_no_network(downloaded, tmp_path,
                                               monkeypatch, capsys):
    first, _, _ = downloaded
    cache = tmp_path / "by_hand"
    for stem, fixture in FILES.items():
        (cache / GROUP / stem).mkdir(parents=True)
        shutil.copyfile(DATA / f"{fixture}.mtx",
                        cache / GROUP / stem / f"{stem}.mtx")
    monkeypatch.setattr(port_ss, "BASE_URL", f"file://{tmp_path / 'gone'}")
    rows = cli.main(CLI_SWEEP + ["--download", "--instances", INSTANCES,
                                 "--cache-dir", str(cache)])
    out = capsys.readouterr().out
    assert f"# suitesparse: 3 instance(s) cached under {cache}" in out
    assert "| stand_in | suitesparse | log2_scaled_nonneg | torch |" in out
    assert _untimed(rows) == _untimed(first)
    assert not (cache / "checksums.json").exists()  # nothing was fetched


def test_one_unreachable_instance_is_skipped(downloaded, tmp_path,
                                             monkeypatch, capsys):
    cache = tmp_path / "some"
    (cache / GROUP / "stand_in").mkdir(parents=True)
    shutil.copyfile(DATA / "zcoil7.mtx",
                    cache / GROUP / "stand_in" / "stand_in.mtx")
    monkeypatch.setattr(port_ss, "BASE_URL", f"file://{tmp_path / 'gone'}")
    rows = cli.main(CLI_SWEEP + [
        "--download", "--instances", f"{GROUP}/stand_in,{GROUP}/absent",
        "--cache-dir", str(cache)])
    out = capsys.readouterr().out
    assert "# suitesparse: SKIPPED" in out and "absent" in out
    assert {r.name for r in rows if r.source == "suitesparse"} == \
        {"stand_in"}


# ------------------------------- on the card -------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel backends launch CUDA "
                    "C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.gpu
def test_download_row_on_the_card(cuda, tmp_path, monkeypatch):
    import torch.distributed as tdist

    if tdist.is_initialized() and tdist.get_backend() != "nccl":
        tdist.destroy_process_group()  # a CPU test's one-rank gloo grid
    serve = _serve(tmp_path / "serve")
    monkeypatch.setattr(port_ss, "BASE_URL", f"file://{serve}")
    rows = cli.main(["--quick", "--suite-count", "0", "--no-persist",
                     "--backends", "cuda_persistent", "--grids", "1x1",
                     "--download", "--instances", f"{GROUP}/stand_in",
                     "--cache-dir", str(tmp_path / "cache")])
    (row,) = [r for r in rows
              if r.source == "suitesparse" and r.engine == "cuda_persistent"]
    assert row.device.startswith("cuda")
    assert row.transform == "log2_scaled_nonneg"
    assert row.perfect and row.certified_sound and row.identical_to_reference
