"""The port's data layer (``repro_torch.data``: Matrix Market I/O, the
weight transforms, ``load_problem``; ``sparse.csr.dedupe_coo_sum``)
against the JAX package's, exactly.

One JAX child reads every fixture of ``tests/data`` (stored and
expanded), loads it under every weight transform, assembles a random COO
list with duplicates and parses a set of malformed files; the port must
give the same arrays bit for bit and the same error messages. Then the
port on its own: read -> write -> read round trips on all six fixtures,
symmetric and hermitian expansion, and ``load_problem``'s pipeline.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.api import MatchingProblem  # noqa: E402
from repro_torch.data import matrices  # noqa: E402
from repro_torch.data.mtx import (  # noqa: E402
    MatrixMarketError,
    load_problem,
    read_mtx,
    write_mtx,
)
from repro_torch.data.weight_transforms import (  # noqa: E402
    TRANSFORMS,
    compose,
    get_transform,
    log2_scaled,
    log2_scaled_nonneg,
)
from repro_torch.sparse.csr import dedupe_coo_sum  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
FIXTURES = sorted(DATA.glob("*.mtx"))
STEMS = [p.stem for p in FIXTURES]
LOADS = ("abs", "rowcol", "log2_scaled", "log2_scaled_nonneg", "none",
         "abs+rowcol")

BAD = {
    "banner": "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
    "field": "%%MatrixMarket matrix coordinate quaternion general\n1 1 1\n",
    "size": "%%MatrixMarket matrix coordinate real general\n2 x 1\n",
    "short": "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n",
    "long": "%%MatrixMarket matrix coordinate real general\n2 2 1\n"
            "1 1 1.0\n2 2 1.0\n",
    "outside": "%%MatrixMarket matrix coordinate real general\n2 2 1\n"
               "3 1 1.0\n",
    "nan": "%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 nan\n",
    "tokens": "%%MatrixMarket matrix coordinate pattern general\n2 2 1\n"
              "1 1 1.0\n",
    "triangles": "%%MatrixMarket matrix coordinate real symmetric\n2 2 2\n"
                 "2 1 1.0\n1 2 1.0\n",
    "skew_diag": "%%MatrixMarket matrix coordinate real skew-symmetric\n"
                 "2 2 1\n1 1 3.0\n",
    "herm_diag": "%%MatrixMarket matrix coordinate complex hermitian\n"
                 "2 2 1\n1 1 1.0 2.0\n",
    "herm_real": "%%MatrixMarket matrix coordinate real hermitian\n1 1 1\n"
                 "1 1 1.0\n",
}

REFERENCE = """
import pathlib
from repro.data.mtx import MatrixMarketError, load_problem, read_mtx
from repro.data.weight_transforms import TRANSFORMS, compose, get_transform
from repro.sparse.csr import dedupe_coo_sum

def spec(name):
    if name == "none":
        return None
    if name == "abs+rowcol":
        return compose("abs", "rowcol")
    return name

for stem in STEMS:
    path = DATA / f"{stem}.mtx"
    for expand in (False, True):
        m = read_mtx(path, expand_symmetry=expand)
        k = f"{stem}__read{int(expand)}__"
        OUT[k + "row"], OUT[k + "col"], OUT[k + "val"] = m.row, m.col, m.val
        OUT[k + "meta"] = np.array([m.nrows, m.ncols, int(m.expanded)])
        OUT[k + "kind"] = np.array(f"{m.field} {m.symmetry}")
    for name in LOADS:
        p, coo = load_problem(path, transform=spec(name))
        k = f"{stem}__load_{name}__"
        OUT[k + "row"], OUT[k + "col"] = p.row, p.col
        OUT[k + "val"], OUT[k + "n"] = p.val, p.n
        OUT[k + "coo_val"] = coo.val
    m = read_mtx(path)
    r, c, v = dedupe_coo_sum(m.row, m.col, m.val, n_cols=m.ncols)
    a = np.abs(v[v != 0])
    r, c = r[v != 0], c[v != 0]
    for name, fn in TRANSFORMS.items():
        OUT[f"{stem}__tf_{name}"] = fn(r, c, a, m.nrows)
r, c, v = dedupe_coo_sum(IN["dup_row"], IN["dup_col"], IN["dup_val"])
OUT["dup_row"], OUT["dup_col"], OUT["dup_val"] = r, c, v
r, c, v = dedupe_coo_sum(IN["dup_row"], IN["dup_col"], IN["dup_val"],
                         n_cols=50)
OUT["dup50_row"], OUT["dup50_col"], OUT["dup50_val"] = r, c, v
for name in BAD:
    try:
        read_mtx(BADDIR / f"{name}.mtx")
        OUT[f"bad__{name}"] = np.array("no error")
    except MatrixMarketError as e:
        OUT[f"bad__{name}"] = np.array(str(e))
"""


def _spec(name):
    if name == "none":
        return None
    if name == "abs+rowcol":
        return compose("abs", "rowcol")
    return name


def _dups():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 40, 300), rng.integers(0, 40, 300),
            rng.standard_normal(300))


@pytest.fixture(scope="module")
def bad_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bad_mtx")
    for name, content in BAD.items():
        (d / f"{name}.mtx").write_text(content)
    return d


@pytest.fixture(scope="module")
def jax_data(tmp_path_factory, bad_dir):
    row, col, val = _dups()
    header = (f"import pathlib\nSTEMS = {STEMS!r}\nLOADS = {LOADS!r}\n"
              f"BAD = {list(BAD)!r}\nDATA = pathlib.Path({str(DATA)!r})\n"
              f"BADDIR = pathlib.Path({str(bad_dir)!r})\n")
    return run_reference(header + REFERENCE,
                         {"dup_row": row, "dup_col": col, "dup_val": val},
                         tmp_path_factory.mktemp("mtx"))


def _bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("expand", [False, True])
@pytest.mark.parametrize("stem", STEMS)
def test_read_mtx_equals_jax(jax_data, stem, expand):
    m = read_mtx(DATA / f"{stem}.mtx", expand_symmetry=expand)
    k = f"{stem}__read{int(expand)}__"
    for f in ("row", "col", "val"):
        _bits(getattr(m, f), jax_data[k + f], f)
    assert [m.nrows, m.ncols, int(m.expanded)] == jax_data[k + "meta"].tolist()
    assert f"{m.field} {m.symmetry}" == str(jax_data[k + "kind"])


@pytest.mark.parametrize("name", LOADS)
@pytest.mark.parametrize("stem", STEMS)
def test_load_problem_equals_jax(jax_data, stem, name):
    p, coo = load_problem(DATA / f"{stem}.mtx", transform=_spec(name),
                          device="cpu")
    assert isinstance(p, MatchingProblem) and p.device.type == "cpu"
    k = f"{stem}__load_{name}__"
    for f in ("row", "col", "val"):
        _bits(getattr(p, f).numpy(), jax_data[k + f], f)
    assert p.n == int(jax_data[k + "n"])
    _bits(coo.val, jax_data[k + "coo_val"], "coo.val")


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_weight_transforms_equal_jax(jax_data, name):
    for stem in STEMS:
        m = read_mtx(DATA / f"{stem}.mtx")
        r, c, v = dedupe_coo_sum(m.row, m.col, m.val, n_cols=m.ncols)
        keep = v != 0
        got = TRANSFORMS[name](r[keep], c[keep], np.abs(v[keep]), m.nrows)
        _bits(got, jax_data[f"{stem}__tf_{name}"], f"{stem} {name}")


def test_dedupe_coo_sum_equals_jax(jax_data):
    row, col, val = _dups()
    for k, kw in (("dup", {}), ("dup50", {"n_cols": 50})):
        got = dedupe_coo_sum(row, col, val, **kw)
        for f, a in zip(("row", "col", "val"), got):
            _bits(a, jax_data[f"{k}_{f}"], f"{k} {f}")
    assert dedupe_coo_sum(np.zeros(0), np.zeros(0), np.zeros(0))[0].size == 0


@pytest.mark.parametrize("name", list(BAD))
def test_malformed_files_fail_with_jax_messages(jax_data, bad_dir, name):
    with pytest.raises(MatrixMarketError) as e:
        read_mtx(bad_dir / f"{name}.mtx")
    assert str(e.value) == str(jax_data[f"bad__{name}"])


# --------------------------------------------------------------------------
# the port on its own
# --------------------------------------------------------------------------


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_roundtrip_bit_equal(path, tmp_path):
    a = read_mtx(path, expand_symmetry=False)
    out = tmp_path / path.name
    write_mtx(out, a.row, a.col, None if a.field == "pattern" else a.val,
              shape=(a.nrows, a.ncols), field=a.field, symmetry=a.symmetry)
    b = read_mtx(out, expand_symmetry=False)
    assert (b.nrows, b.ncols, b.field, b.symmetry) == \
        (a.nrows, a.ncols, a.field, a.symmetry)
    assert np.array_equal(a.row, b.row) and np.array_equal(a.col, b.col)
    assert a.val.tobytes() == b.val.tobytes()


def test_roundtrip_exotic_values(tmp_path):
    val = np.array([0.1, 1e-300, 1.7976931348623157e308, -3.141592653589793,
                    2.0 ** -52])
    out = tmp_path / "exotic.mtx"
    write_mtx(out, np.arange(5), np.arange(5), val, shape=(5, 5))
    assert read_mtx(out).val.tobytes() == val.tobytes()


def test_symmetric_and_hermitian_expansion(tmp_path):
    stored = read_mtx(DATA / "bands6_sym.mtx", expand_symmetry=False)
    full = read_mtx(DATA / "bands6_sym.mtx")
    n_diag = int((stored.row == stored.col).sum())
    assert full.nnz == 2 * stored.nnz - n_diag and full.expanded
    out = tmp_path / "herm.mtx"
    write_mtx(out, [0, 1], [0, 0], [2.0 + 0j, 1.0 + 3.0j], shape=(2, 2),
              symmetry="hermitian")
    m = read_mtx(out)
    d = {(int(i), int(j)): v for i, j, v in zip(m.row, m.col, m.val)}
    assert d[(0, 1)] == 1.0 - 3.0j


def test_write_mtx_refusals(tmp_path):
    with pytest.raises(MatrixMarketError, match="non-finite"):
        write_mtx(tmp_path / "w.mtx", [0, 1], [0, 1], [1.0, float("inf")],
                  shape=(2, 2))
    with pytest.raises(MatrixMarketError, match="hermitian"):
        write_mtx(tmp_path / "w.mtx", [0], [0], [1.0], symmetry="hermitian")
    with pytest.raises(MatrixMarketError, match="integral"):
        write_mtx(tmp_path / "w.mtx", [0], [0], [1.5], field="integer")


def test_load_problem_pipeline(tmp_path):
    out = tmp_path / "dup.mtx"
    out.write_text("%%MatrixMarket matrix coordinate real general\n"
                   "2 2 6\n1 1 1.5\n1 1 2.0\n2 2 1.0\n2 1 0.25\n1 2 4.0\n"
                   "1 2 -4.0\n")
    p, _ = load_problem(out, transform=None, device="cpu")
    row, val = p.row.numpy(), p.val.numpy()
    assert int((row < p.n).sum()) == 3  # the cancelled (1, 2) pair is gone
    assert val[row == 0][0] == pytest.approx(3.5)  # 1.5 + 2.0 assembled
    rect = tmp_path / "rect.mtx"
    rect.write_text("%%MatrixMarket matrix coordinate real general\n"
                    "2 3 1\n1 1 1.0\n")
    with pytest.raises(MatrixMarketError, match="square"):
        load_problem(rect, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_problem(out)


def test_transform_plumbing():
    assert get_transform(log2_scaled) is log2_scaled
    with pytest.raises(KeyError, match="unknown weight transform"):
        get_transform("log10")
    with pytest.raises(TypeError, match="weight transform"):
        get_transform(3)
    row, col = np.array([0, 1, 0]), np.array([0, 0, 1])
    val = np.array([4.0, 2.0, 1.0])
    w = get_transform(["abs", "log2_scaled_nonneg"])(row, col, val, 2)
    assert np.array_equal(w, log2_scaled_nonneg(row, col, val, 2))
    with pytest.raises(ValueError, match="zero entries"):
        log2_scaled(row, col, np.array([4.0, 0.0, 1.0]), 2)
    assert set(matrices.__all__) >= {"read_mtx", "load_problem",
                                     "partition_coo_2d", "SUITE_KINDS"}
