"""The port's SuiteSparse fetcher (``data.suitesparse``) against the JAX
package's, on the CPU, with no network: the test builds ``.tar.gz``
archives of a ``tests/data`` fixture and serves them as ``file://`` URLs
(``BASE_URL`` patched in both packages). The same scenarios run on both
sides, each into caches of its own:

  - a fetch: the extracted ``.mtx`` bytes, its place in the cache and the
    trust-on-first-use pin store (``checksums.json``) equal JAX's; a
    second fetch is served from the cache with the URL gone;
  - ``SuiteSparseUnavailable`` on a sha256 mismatch (a pinned registry
    hash, and a republished tarball against the cache's own pin), on an
    archive without the instance's member and on an unreachable URL, with
    the same message once each side's cache directory is named alike;
  - ``fetch_paper_instances`` keeps what it could fetch and raises when
    nothing could be; an unknown name raises KeyError.
"""
import gzip
import io
import json
import pathlib
import tarfile

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.data import suitesparse as port_ss  # noqa: E402
from test_torch_harness import REPO, run_reference  # noqa: E402

FIXTURE = REPO / "tests" / "data" / "circuit8.mtx"

# run(ss, root, serve): each scenario's outcome, on either package
SCENARIOS = '''
import json
import pathlib
import shutil


def run(ss, root, serve):
    root, serve = pathlib.Path(root), pathlib.Path(serve)
    out = {}

    def attempt(name, fn):
        try:
            out[name] = ("ok", fn())
        except Exception as e:
            msg = str(e).replace(str(root), "<root>")
            out[name] = ("raised", type(e).__name__, msg)

    def fetch_ok():
        cache = root / "ok"
        ss.BASE_URL = f"file://{serve / 'v1'}"
        path = ss.fetch("Test/circuit8", cache=cache)
        ss.BASE_URL = f"file://{serve / 'gone'}"
        again = ss.fetch("Test/circuit8", cache=cache)
        return dict(rel=str(path.relative_to(cache)), same=again == path,
                    mtx=path.read_bytes().decode(),
                    pins=(cache / "checksums.json").read_text(),
                    files=sorted(str(p.relative_to(cache))
                                 for p in cache.rglob("*")))

    attempt("fetch", fetch_ok)

    def pinned_mismatch():
        ss.BASE_URL = f"file://{serve / 'v1'}"
        inst = ss.SuiteSparseInstance("circuit8", "Test", sha256="0" * 64)
        return ss.fetch(inst, cache=root / "pinned")

    attempt("pinned_mismatch", pinned_mismatch)

    def republished():
        cache = root / "tofu"
        ss.BASE_URL = f"file://{serve / 'v1'}"
        path = ss.fetch("Test/circuit8", cache=cache)
        shutil.rmtree(path.parent)
        (cache / "Test" / "circuit8.tar.gz").unlink()
        ss.BASE_URL = f"file://{serve / 'v2'}"
        return ss.fetch("Test/circuit8", cache=cache)

    attempt("republished", republished)

    def missing_member():
        ss.BASE_URL = f"file://{serve / 'v1'}"
        return ss.fetch("Test/nomember", cache=root / "member")

    attempt("missing_member", missing_member)

    def unreachable():
        ss.BASE_URL = f"file://{serve / 'v1'}"
        return ss.fetch("Test/absent", cache=root / "absent")

    attempt("unreachable", unreachable)

    def some():
        ss.BASE_URL = f"file://{serve / 'v1'}"
        got = ss.fetch_paper_instances(["Test/circuit8", "Test/absent"],
                                       cache=root / "some")
        return {k: str(v.relative_to(root)) for k, v in got.items()}

    attempt("paper_some", some)
    attempt("paper_none", lambda: ss.fetch_paper_instances(
        ["Test/absent"], cache=root / "none"))
    attempt("unknown", lambda: ss.fetch("circuit8", cache=root / "unknown"))
    out["registry"] = ("ok", [(i.name, i.group, i.sha256, i.url)
                              for i in ss.PAPER_INSTANCES])
    return json.dumps(out, sort_keys=True)
'''

REFERENCE = SCENARIOS + """
from repro.data import suitesparse as ss

base = ss.BASE_URL
OUT["registry_base"] = base
OUT["out"] = run(ss, str(IN["root"]), str(IN["serve"]))
"""


def _tarball(path: pathlib.Path, members: dict) -> None:
    """A deterministic ``.tar.gz`` of ``members`` ({name: bytes})."""
    raw = io.BytesIO()
    with tarfile.open(fileobj=raw, mode="w") as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size, info.mtime = len(data), 0
            tf.addfile(info, io.BytesIO(data))
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f, gzip.GzipFile(fileobj=f, mode="wb",
                                              mtime=0) as gz:
        gz.write(raw.getvalue())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    serve = tmp_path_factory.mktemp("serve")
    body = FIXTURE.read_bytes()
    _tarball(serve / "v1" / "Test" / "circuit8.tar.gz",
             {"circuit8/circuit8.mtx": body,
              "circuit8/circuit8_b.mtx": b"%%MatrixMarket auxiliary\n"})
    _tarball(serve / "v2" / "Test" / "circuit8.tar.gz",
             {"circuit8/circuit8.mtx": body + b"% republished\n"})
    _tarball(serve / "v1" / "Test" / "nomember.tar.gz",
             {"other/other.mtx": body})
    return serve


def _run(ss, root, serve, monkeypatch):
    namespace = {}
    exec(SCENARIOS, namespace)
    monkeypatch.setattr(ss, "BASE_URL", ss.BASE_URL)  # restored after
    return json.loads(namespace["run"](ss, root, serve))


@pytest.fixture(scope="module")
def both(served, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_cache")
    ref = run_reference(REFERENCE, {"root": np.array(str(root)),
                                    "serve": np.array(str(served))},
                        tmp_path_factory.mktemp("jax"))
    with pytest.MonkeyPatch.context() as mp:
        port = _run(port_ss, tmp_path_factory.mktemp("port_cache"), served,
                    mp)
    return port, json.loads(str(ref["out"])), str(ref["registry_base"])


@pytest.mark.parametrize("scenario", [
    "fetch", "pinned_mismatch", "republished", "missing_member",
    "unreachable", "paper_some", "paper_none", "unknown", "registry"])
def test_scenario_equals_jax(both, scenario):
    port, jax_out, _ = both
    assert port[scenario] == jax_out[scenario]


def test_outcomes(both):
    port, _, base = both
    assert port_ss.BASE_URL == base  # restored after the patch
    status, got = port["fetch"]
    assert status == "ok" and got["same"]
    assert got["mtx"] == FIXTURE.read_text()
    assert got["rel"] == "Test/circuit8/circuit8.mtx"
    assert "Test/circuit8/circuit8_b.mtx" not in got["files"]
    assert list(json.loads(got["pins"])) == ["Test/circuit8"]
    for name, needle in (("pinned_mismatch", "sha256 mismatch"),
                         ("republished", "sha256 mismatch"),
                         ("missing_member", "does not contain"),
                         ("unreachable", "could not download"),
                         ("paper_none", "every SuiteSparse fetch failed")):
        assert port[name][:2] == ["raised", "SuiteSparseUnavailable"], name
        assert needle in port[name][2], name
    assert port["paper_some"] == ["ok", {"circuit8": "some/Test/circuit8/"
                                         "circuit8.mtx"}]
    assert port["unknown"][:2] == ["raised", "KeyError"]


def test_nothing_imports_urllib_at_module_scope():
    src = pathlib.Path(port_ss.__file__).read_text()
    head = src[:src.index("def _download")]
    assert "urllib" not in head.split('"""', 2)[2]
