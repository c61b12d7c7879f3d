"""The GNN slice's data, bases and sparse primitives against the JAX
package, on the CPU: the graph generators (``data/graphs.py``, triplets
included) and the neighbour sampler (``models/gnn/sampler.py``) array for
array at the same seeds; the cells' sizes; the radial basis, the real
spherical harmonics (at l_max 2, 4 and 6, within 1e-5) and the message
aggregation with its gradient; and ``coo_spmm``, ``coo_sddmm``,
``segment_softmax``, ``segment_argmax`` and the padded CSR on the cases of
the JAX package's ``tests/test_sparse.py``. The scipy and rotation cases
of ``tests/test_model_math.py`` run on the port alone.

The JAX side runs once in a child process
(``test_torch_harness.run_reference``).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import GNN_SHAPES  # noqa: E402
from repro_torch.data import graphs as G  # noqa: E402
from repro_torch.models.gnn import common  # noqa: E402
from repro_torch.models.gnn.sampler import build_csr, sample_blocks  # noqa: E402
from repro_torch.sparse import (  # noqa: E402
    coo_sddmm,
    coo_spmm,
    coo_to_padded_csr,
    segment_argmax,
    segment_softmax,
    sort_coo,
)
from test_torch_harness import run_reference  # noqa: E402

# random_graph calls: (n_nodes, n_edges, d_feat, kwargs)
GRAPHS = {
    "single": (80, 240, 8, dict(n_classes=7, seed=0)),
    "coords": (80, 240, 8, dict(n_classes=7, seed=1, coords=True)),
    "triplets": (80, 240, 8, dict(n_classes=7, seed=2, coords=True,
                                  triplets=True)),
    "molecules": (60, 128, 8, dict(seed=3, coords=True, n_graphs=4,
                                   triplets=True)),
    "launcher": (128, 512, 16, dict(n_classes=7, seed=4, coords=True,
                                    triplets=True)),
}
GRAPHCAST = {"small": (120, 12, 0), "launcher": (256, 227, 5)}
SAMPLER = dict(n=2000, e=12000, seeds=16, fanouts=[5, 3], seed=0)
L_MAXES = (2, 4, 6)


def _rand_coo(n, m, seed=0):
    """``tests/test_sparse.py::_rand_coo``: distinct (row, col) pairs."""
    rng = np.random.default_rng(seed)
    rr = rng.integers(0, n, m).astype(np.int32)
    cc = rng.integers(0, n, m).astype(np.int32)
    key = rr.astype(np.int64) * n + cc
    _, idx = np.unique(key, return_index=True)
    rr, cc = rr[idx], cc[idx]
    vv = rng.uniform(0.1, 1.0, rr.shape[0]).astype(np.float32)
    return rr, cc, vv


def _sparse_inputs():
    n, pad = 37, 17
    rr, cc, vv = _rand_coo(n, 200)
    x = np.random.default_rng(1).normal(size=(n, 8)).astype(np.float32)
    out = dict(
        spmm_row=np.concatenate([rr, np.full(pad, n, np.int32)]),
        spmm_col=np.concatenate([cc, np.full(pad, n, np.int32)]),
        spmm_val=np.concatenate([vv, np.zeros(pad, np.float32)]),
        spmm_x=np.concatenate([x, np.zeros((1, 8), np.float32)]),
        spmm_dense=np.zeros((n, n), np.float32), spmm_x0=x)
    out["spmm_dense"][rr, cc] = vv
    rr, cc, _ = _rand_coo(19, 80)
    out.update(sddmm_row=rr, sddmm_col=cc,
               sddmm_a=np.random.default_rng(2).normal(size=(19, 6)).astype(
                   np.float32),
               sddmm_b=np.random.default_rng(3).normal(size=(19, 6)).astype(
                   np.float32))
    # segment softmax and argmax: ties, an empty segment (2), and 2-D logits
    rng = np.random.default_rng(4)
    out.update(
        soft_seg=np.array([0, 0, 1, 1, 1, 3], np.int32),
        soft_logits=np.array([0.5, -1.0, 2.0, 2.0, 0.0, 5.0], np.float32),
        soft_seg2=rng.integers(0, 9, 50).astype(np.int32),
        soft_logits2=rng.normal(size=(50, 3)).astype(np.float32) * 4,
        arg_vals=np.array([1.0, 3.0, 3.0, -2.0, 0.5, 7.0], np.float32),
        arg_seg=np.array([0, 0, 0, 1, 1, 4], np.int32))
    rr, cc, vv = _rand_coo(11, 40, seed=9)
    out.update(csr_row=rr, csr_col=cc, csr_val=vv)
    return out


def _aggregate_inputs():
    rng = np.random.default_rng(5)
    n, e = 12, 40
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[dst == 7] = 3  # node 7 receives nothing
    dst[-5:] = n  # padding edges go to the sentinel
    # few distinct values: ties inside a node's max
    msg = rng.integers(-3, 4, (e, 5)).astype(np.float32) / 2
    w = rng.normal(size=(n, 5)).astype(np.float32)
    return dict(agg_dst=dst, agg_msg=msg, agg_w=w, agg_n=np.array(n))


def _vectors():
    rng = np.random.default_rng(6)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[0] = 0.0  # a zero vector: normalised by the 1e-9 floor
    v[1] = (0.0, 0.0, 2.0)  # on the pole
    return v


REFERENCE = """
import json

import jax
import jax.numpy as jnp
from repro.configs.base import GNN_SHAPES
from repro.data import graphs as G
from repro.launch.input_specs import _gnn_sizes
from repro.models.gnn import common
from repro.models.gnn.sampler import build_csr, sample_blocks
from repro.sparse import (coo_sddmm, coo_spmm, coo_to_padded_csr,
                          segment_argmax, segment_softmax, sort_coo)


def fields(prefix, obj):
    for k, v in vars(obj).items():
        if isinstance(v, tuple):
            for i, t in enumerate(v):
                OUT[f"{prefix}__{k}{i}"] = t
        elif v is not None:
            OUT[f"{prefix}__{k}"] = np.asarray(v)


for name, (n, e, d, kw) in json.loads(str(IN["graphs"])).items():
    fields("graph_" + name, G.random_graph(n, e, d, **kw))
for name, (ng, nv, seed) in json.loads(str(IN["graphcast"])).items():
    fields("gc_" + name, G.random_graphcast_batch(ng, nv, seed=seed))

s = json.loads(str(IN["sampler"]))
rng = np.random.default_rng(s["seed"])
src = rng.integers(0, s["n"], s["e"])
dst = rng.integers(0, s["n"], s["e"])
OUT["csr_ptr"], OUT["csr_nbrs"] = ptr, nbrs = build_csr(s["n"], src, dst)
blocks = sample_blocks(ptr, nbrs, rng.integers(0, s["n"], s["seeds"]),
                       s["fanouts"], rng)
for k, v in blocks._asdict().items():
    OUT["blocks__" + k] = np.asarray(v)

for spec in GNN_SHAPES:
    OUT["shape__" + spec.name] = json.dumps(
        [spec.mode, [list(kv) for kv in spec.dims]])
    OUT["sizes__" + spec.name] = np.array(_gnn_sizes(spec))
    if spec.name == "minibatch_lg":
        OUT["sampled_sizes"] = np.array(G.sampled_sizes(
            spec.d("batch_nodes"), (spec.d("fanout1"), spec.d("fanout2"))))
    n_grid = _gnn_sizes(spec)[0]
    OUT["gc_sizes__" + spec.name] = json.dumps(G.graphcast_sizes(n_grid))

v = jnp.asarray(IN["vectors"])
for l_max in json.loads(str(IN["l_maxes"])):
    OUT[f"sh{l_max}"] = common.real_spherical_harmonics(v, l_max)
    OUT[f"sh_ls{l_max}"], OUT[f"sh_ms{l_max}"] = common.sh_degree_index(l_max)
dist = jnp.linalg.norm(v, axis=-1)
OUT["rbf"] = common.radial_basis(dist, 6)
OUT["rbf_cut"] = common.radial_basis(dist, 8, cutoff=3.0)

n = int(IN["agg_n"])
msg, dst, w = (jnp.asarray(IN[k]) for k in ("agg_msg", "agg_dst", "agg_w"))
for op in ("sum", "mean", "max"):
    f = lambda m: jnp.sum(common.aggregate(m, dst, n, op) * w)
    OUT["agg_" + op] = common.aggregate(msg, dst, n, op)
    OUT["agg_grad_" + op] = jax.grad(f)(msg)

OUT["spmm"] = coo_spmm(*(jnp.asarray(IN["spmm_" + k])
                        for k in ("row", "col", "val", "x")),
                       int(IN["spmm_x0"].shape[0]))
OUT["sddmm"] = coo_sddmm(*(jnp.asarray(IN["sddmm_" + k])
                          for k in ("row", "col", "a", "b")))
OUT["softmax"] = segment_softmax(jnp.asarray(IN["soft_logits"]),
                                 jnp.asarray(IN["soft_seg"]), 4)
OUT["softmax2"] = segment_softmax(jnp.asarray(IN["soft_logits2"]),
                                  jnp.asarray(IN["soft_seg2"]), 10)
OUT["argmax"] = segment_argmax(jnp.asarray(IN["arg_vals"]),
                               jnp.asarray(IN["arg_seg"]), 6)
csr = coo_to_padded_csr(IN["csr_row"], IN["csr_col"], IN["csr_val"], 11, 11,
                        capacity=64)
for k in ("row_ptr", "row", "col", "val"):
    OUT["csr__" + k] = getattr(csr, k)
OUT["csr__nnz"] = csr.nnz
OUT["sorted"] = np.stack(sort_coo(IN["csr_row"], IN["csr_col"],
                                  IN["csr_val"]))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = dict(graphs=np.array(json.dumps(GRAPHS)),
                  graphcast=np.array(json.dumps(GRAPHCAST)),
                  sampler=np.array(json.dumps(SAMPLER)),
                  l_maxes=np.array(json.dumps(L_MAXES)),
                  vectors=_vectors(), **_sparse_inputs(),
                  **_aggregate_inputs())
    return run_reference(REFERENCE, inputs,
                         tmp_path_factory.mktemp("gnn_data"))


def _fields_equal(ref, prefix, obj):
    """Every field of ``obj`` equals JAX's, arrays with their dtypes."""
    seen = 0
    for k, v in vars(obj).items():
        parts = enumerate(v) if isinstance(v, tuple) else [("", v)]
        for i, a in parts:
            if a is None:
                continue
            want = ref[f"{prefix}__{k}{i}"]
            if isinstance(a, int):  # n_graphs, n_mesh
                assert a == int(want), (prefix, k)
                seen += 1
                continue
            assert a.dtype == want.dtype, (prefix, k)
            np.testing.assert_array_equal(a, want, err_msg=f"{prefix} {k}")
            seen += 1
    assert seen == sum(1 for key in ref if key.startswith(prefix + "__"))


@pytest.mark.parametrize("name", GRAPHS)
def test_random_graph_equals_jax(ref, name):
    n, e, d, kw = GRAPHS[name]
    gb = G.random_graph(n, e, d, **kw)
    _fields_equal(ref, "graph_" + name, gb)
    assert gb.n_graphs == kw.get("n_graphs", 1)
    if kw.get("triplets"):
        kj, ji = gb.triplets
        assert kj.shape == (G.TRIPLET_FACTOR * e,)
        assert ((kj < e) == (ji < e)).all() and (kj < e).any()


@pytest.mark.parametrize("name", GRAPHCAST)
def test_random_graphcast_batch_equals_jax(ref, name):
    ng, nv, seed = GRAPHCAST[name]
    gb = G.random_graphcast_batch(ng, nv, seed=seed)
    _fields_equal(ref, "gc_" + name, gb)
    assert gb.n_mesh == G.graphcast_sizes(ng)["n_mesh"]


def test_build_csr_and_sample_blocks_equal_jax(ref):
    s = SAMPLER
    rng = np.random.default_rng(s["seed"])
    src = rng.integers(0, s["n"], s["e"])
    dst = rng.integers(0, s["n"], s["e"])
    ptr, nbrs = build_csr(s["n"], src, dst)
    for got, key in ((ptr, "csr_ptr"), (nbrs, "csr_nbrs")):
        assert got.dtype == ref[key].dtype
        np.testing.assert_array_equal(got, ref[key])
    blocks = sample_blocks(ptr, nbrs, rng.integers(0, s["n"], s["seeds"]),
                           s["fanouts"], rng)
    for k, v in blocks._asdict().items():
        want = ref["blocks__" + k]
        v = np.asarray(v)
        assert v.dtype == want.dtype, k
        np.testing.assert_array_equal(v, want, err_msg=k)


@pytest.mark.parametrize("spec", GNN_SHAPES, ids=lambda s: s.name)
def test_shape_cells_and_sizes_equal_jax(ref, spec):
    mode, dims = json.loads(str(ref["shape__" + spec.name]))
    assert (spec.mode, [list(kv) for kv in spec.dims]) == (mode, dims)
    if spec.name == "minibatch_lg":
        got = G.sampled_sizes(spec.d("batch_nodes"),
                              (spec.d("fanout1"), spec.d("fanout2")))
        np.testing.assert_array_equal(got, ref["sampled_sizes"])
        assert got == (169_984, 168_960)
    n_grid = int(ref["sizes__" + spec.name][0])
    assert G.graphcast_sizes(n_grid) == json.loads(
        str(ref["gc_sizes__" + spec.name]))


def test_graphcast_sizes_of_the_chip_cell():
    assert G.graphcast_sizes(169_984) == {
        "n_mesh": 10_624, "e_g2m": 339_968, "e_mesh": 74_368,
        "e_m2g": 509_952}


@pytest.mark.parametrize("l_max", L_MAXES)
def test_spherical_harmonics_match_jax(ref, l_max):
    got = common.real_spherical_harmonics(torch.from_numpy(_vectors()),
                                          l_max)
    assert got.shape == (64, (l_max + 1) ** 2)
    np.testing.assert_allclose(got.numpy(), ref[f"sh{l_max}"], rtol=0,
                               atol=1e-5)
    ls, ms = common.sh_degree_index(l_max)
    np.testing.assert_array_equal(ls, ref[f"sh_ls{l_max}"])
    np.testing.assert_array_equal(ms, ref[f"sh_ms{l_max}"])


def test_radial_basis_matches_jax(ref):
    dist = torch.linalg.vector_norm(torch.from_numpy(_vectors()), dim=-1)
    np.testing.assert_allclose(common.radial_basis(dist, 6).numpy(),
                               ref["rbf"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        common.radial_basis(dist, 8, cutoff=3.0).numpy(), ref["rbf_cut"],
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_aggregate_and_its_gradient_match_jax(ref, op):
    """Sum, mean and max over the nodes, padding sent to the sentinel
    row; an empty node gives 0 (max: from -inf); max's gradient goes in
    equal shares to tied entries, as JAX's."""
    inp = _aggregate_inputs()
    n = int(inp["agg_n"])
    msg = torch.from_numpy(inp["agg_msg"]).requires_grad_(True)
    dst = torch.from_numpy(inp["agg_dst"])
    out = common.aggregate(msg, dst, n, op)
    assert out.shape == (n, 5) and float(out[7].abs().max()) == 0.0
    np.testing.assert_allclose(out.detach().numpy(), ref["agg_" + op],
                               rtol=1e-6, atol=1e-6)
    (out * torch.from_numpy(inp["agg_w"])).sum().backward()
    np.testing.assert_allclose(msg.grad.numpy(), ref["agg_grad_" + op],
                               rtol=1e-6, atol=1e-6)


def test_aggregate_refuses_an_unknown_op():
    with pytest.raises(ValueError):
        common.aggregate(torch.zeros(2, 1), torch.zeros(2, dtype=torch.int32),
                         1, "min")


def _ref_real_sph_harm(theta, phi, l, m):
    """``tests/test_model_math.py``: real SH from scipy's complex Y_lm."""
    try:  # scipy >= 1.15: sph_harm_y(l, m, polar, azimuth)
        from scipy.special import sph_harm_y
    except ImportError:  # older scipy: sph_harm(m, l, azimuth, polar)
        from scipy.special import sph_harm

        def sph_harm_y(l, m, polar, azimuth):
            return sph_harm(m, l, azimuth, polar)

    y = sph_harm_y(l, abs(m), theta, phi)
    if m == 0:
        return y.real
    if m > 0:
        return np.sqrt(2) * (-1) ** m * y.real
    return np.sqrt(2) * (-1) ** m * y.imag


@pytest.mark.parametrize("l_max", L_MAXES)
def test_spherical_harmonics_match_scipy(l_max):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(50, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    theta = np.arccos(np.clip(v[:, 2], -1, 1))
    phi = np.arctan2(v[:, 1], v[:, 0])
    ours = common.real_spherical_harmonics(
        torch.from_numpy(v.astype(np.float32)), l_max).numpy()
    ls, ms = common.sh_degree_index(l_max)
    for k, (l, m) in enumerate(zip(ls, ms)):
        ref = _ref_real_sph_harm(theta, phi, int(l), int(m))
        # the convention may differ from Condon-Shortley by (-1)^m:
        # compare up to that fixed sign per (l, m)
        a, b = ours[:, k], ref
        sign = np.sign(np.sum(a * b)) or 1.0
        np.testing.assert_allclose(a, sign * b, rtol=2e-3, atol=2e-3,
                                   err_msg=f"l={l} m={m}")


def test_spherical_harmonics_degree_norm_rotation_invariant():
    """Sum_m Y_lm(v)^2 is rotation invariant (addition theorem)."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(20, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    l_max = 6
    ls, _ = common.sh_degree_index(l_max)
    y1 = common.real_spherical_harmonics(
        torch.from_numpy(v.astype(np.float32)), l_max).numpy()
    y2 = common.real_spherical_harmonics(
        torch.from_numpy((v @ q.T).astype(np.float32)), l_max).numpy()
    for l in range(l_max + 1):
        sel = ls == l
        n1 = (y1[:, sel] ** 2).sum(1)
        n2 = (y2[:, sel] ** 2).sum(1)
        np.testing.assert_allclose(n1, n2, rtol=1e-3, atol=1e-4)
        # addition theorem: sum_m |Y_lm|^2 = (2l+1)/4pi
        np.testing.assert_allclose(n1, (2 * l + 1) / (4 * np.pi), rtol=1e-3)


def _t(name):
    return torch.from_numpy(_sparse_inputs()[name])


def test_coo_spmm_matches_jax_and_dense(ref):
    inp = _sparse_inputs()
    y = coo_spmm(_t("spmm_row"), _t("spmm_col"), _t("spmm_val"), _t("spmm_x"),
                 inp["spmm_x0"].shape[0])
    np.testing.assert_allclose(y.numpy(), ref["spmm"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), inp["spmm_dense"] @ inp["spmm_x0"],
                               rtol=1e-5, atol=1e-5)


def test_coo_sddmm_matches_jax_and_dense(ref):
    inp = _sparse_inputs()
    out = coo_sddmm(_t("sddmm_row"), _t("sddmm_col"), _t("sddmm_a"),
                    _t("sddmm_b"))
    np.testing.assert_allclose(out.numpy(), ref["sddmm"], rtol=1e-6,
                               atol=1e-6)
    want = (inp["sddmm_a"] @ inp["sddmm_b"].T)[inp["sddmm_row"],
                                               inp["sddmm_col"]]
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_segment_softmax_matches_jax_and_sums_to_one(ref):
    seg = _t("soft_seg")
    p = segment_softmax(_t("soft_logits"), seg, 4)
    np.testing.assert_allclose(p.numpy(), ref["softmax"], rtol=1e-6)
    sums = np.zeros(4)
    np.add.at(sums, seg.numpy(), p.numpy())
    np.testing.assert_allclose(sums[[0, 1, 3]], 1.0, rtol=1e-6)
    p2 = segment_softmax(_t("soft_logits2"), _t("soft_seg2"), 10)
    np.testing.assert_allclose(p2.numpy(), ref["softmax2"], rtol=1e-6,
                               atol=1e-7)


def test_segment_argmax_matches_jax_with_an_empty_segment(ref):
    got = segment_argmax(_t("arg_vals"), _t("arg_seg"), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref["argmax"])
    # a tie goes to the smaller index; empty segments give -1
    assert got.tolist() == [1, 4, -1, -1, 5, -1]


def test_padded_csr_equals_jax(ref):
    inp = _sparse_inputs()
    csr = coo_to_padded_csr(inp["csr_row"], inp["csr_col"], inp["csr_val"],
                            11, 11, capacity=64)
    assert csr.nnz == int(ref["csr__nnz"]) and csr.capacity == 64
    for k in ("row_ptr", "row", "col", "val"):
        got = getattr(csr, k)
        assert got.dtype == ref["csr__" + k].dtype, k
        np.testing.assert_array_equal(got, ref["csr__" + k], err_msg=k)
    assert csr.row_ptr[-1] == csr.nnz
    for i in range(11):
        s, e = csr.row_ptr[i], csr.row_ptr[i + 1]
        assert (csr.row[s:e] == i).all()
        assert (np.diff(csr.col[s:e]) > 0).all()
    assert csr.valid_mask().sum() == csr.nnz
    np.testing.assert_array_equal(
        np.stack(sort_coo(inp["csr_row"], inp["csr_col"], inp["csr_val"])),
        ref["sorted"])
    with pytest.raises(ValueError, match="capacity"):
        coo_to_padded_csr(inp["csr_row"], inp["csr_col"], inp["csr_val"],
                          11, 11, capacity=3)
