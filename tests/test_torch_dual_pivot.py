"""The port's dual certificate (``core.dual``) and static pivoting
(``core.pivot``) against the JAX package on identical inputs.

Both modules are host numpy over the matching engine, so everything is
compared exactly: the certificate's potentials, weight, bound, tightness
and rounds; the rejection messages; the equilibration, the permutations
(through one batched ``solve()`` on either side, both metrics) and the
pivot-free LU. The JAX side runs once, in one child process. The port
also has to meet the JAX suite's own claims: the bound is sound against
the exact optimum and tight exactly on optimal matchings.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    MatchingProblem,
    SolveOptions,
    dual,
    graph,
    make_grid,
    pivot,
    ref,
    solve,
)
from repro_torch.core.dual import certify, dual_certificate  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

SUITE = graph.matrix_suite(n_matrices=20, n=48)
CERT = ("u", "v", "weight", "upper_bound", "tight", "rounds")
BATCH = [graph.generate(24, avg_degree=4.0, kind=k, seed=s)
         for s, k in enumerate(("uniform", "antigreedy", "circuit"))]
#: (row, col, val, n, mate_row) that dual_certificate must refuse
BAD = {
    "imperfect": (BATCH[0].row, BATCH[0].col, BATCH[0].val, 24,
                  np.full(24, 24)),
    "off_edge_list": (np.array([0, 1]), np.array([0, 1]),
                      np.array([1.0, 1.0]), 2, np.array([1, 0])),
    "twice": (np.array([0, 0, 1]), np.array([0, 1, 0]),
              np.array([1.0, 1.0, 1.0]), 2, np.array([0, 0])),
}


def _ill_system(n, seed):
    """Diagonally weak matrix: pivot-free LU is unstable without a
    permutation (the JAX suite's ``_ill_system``)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.2)
    perm = rng.permutation(n)
    a[perm, np.arange(n)] = rng.uniform(5.0, 10.0, n) * rng.choice([-1, 1], n)
    np.fill_diagonal(a, rng.uniform(0, 1e-8, n))
    return a, a @ np.ones(n)


MATS = [_ill_system(40, s) for s in range(4)]


def _inputs():
    out = {}
    for i, (_, g) in enumerate(SUITE):
        out.update({f"s{i}__row": g.row, f"s{i}__col": g.col,
                    f"s{i}__val": g.val})
    for i, g in enumerate(BATCH):
        out.update({f"b{i}__row": g.row, f"b{i}__col": g.col,
                    f"b{i}__val": g.val})
    for name, (row, col, val, n, mr) in BAD.items():
        out.update({f"bad_{name}__row": row, f"bad_{name}__col": col,
                    f"bad_{name}__val": val, f"bad_{name}__n": np.array(n),
                    f"bad_{name}__mr": mr})
    out["mats"] = np.stack([a for a, _ in MATS])
    out["bs"] = np.stack([b for _, b in MATS])
    return out


REFERENCE = """
from repro.core import graph as G, pivot
from repro.core.api import MatchingProblem, SolveOptions, solve
from repro.core.dual import certify, dual_certificate

def cert_out(prefix, c):
    for k in CERT:
        OUT[prefix + k] = getattr(c, k)

for i in range(N_SUITE):
    g = G.BipartiteGraph(n=48, nnz=int((IN[f"s{i}__row"] < 48).sum()),
                         row=IN[f"s{i}__row"], col=IN[f"s{i}__col"],
                         val=IN[f"s{i}__val"])
    p = MatchingProblem.from_graph(g)
    for tag, opts in (("", None), ("cut_", SolveOptions(max_iter=0))):
        r = solve(p, opts)
        OUT[f"s{i}__{tag}mr"] = r.mate_row
        cert_out(f"s{i}__{tag}", certify(p, r))
gs = [G.BipartiteGraph(n=24, nnz=int((IN[f"b{i}__row"] < 24).sum()),
                       row=IN[f"b{i}__row"], col=IN[f"b{i}__col"],
                       val=IN[f"b{i}__val"]) for i in range(3)]
pb = MatchingProblem.stack(gs)
for i, c in enumerate(certify(pb, solve(pb))):
    cert_out(f"b{i}__", c)
for name in BAD:
    try:
        dual_certificate(*(IN[f"bad_{name}__{k}"] for k in ("row", "col", "val")),
                         int(IN[f"bad_{name}__n"]), IN[f"bad_{name}__mr"])
        OUT[f"bad_{name}"] = "accepted"
    except ValueError as e:
        OUT[f"bad_{name}"] = str(e)

mats, bs = list(IN["mats"]), list(IN["bs"])
for metric in ("product", "sum"):
    perms, iters = pivot.batched_pivot_permutations(mats, metric=metric)
    OUT[f"perm_{metric}"], OUT[f"iters_{metric}"] = perms, iters
xs, _ = pivot.static_pivot_solve_batched(mats, bs)
OUT["xs"] = xs
a_s, d_r, d_c = pivot.equilibrate(mats[0])
OUT["eq_a"], OUT["eq_r"], OUT["eq_c"] = a_s, d_r, d_c
OUT["lu_l"], OUT["lu_u"] = pivot.lu_nopivot(mats[0][OUT["perm_product"][0]])
rr, cc = np.nonzero(a_s)
g = G.from_coo(rr.astype(np.int32), cc.astype(np.int32),
               np.abs(a_s[rr, cc]).astype(np.float32), a_s.shape[0])
OUT["log_val"] = pivot.log_transformed(g).val
"""


@pytest.fixture(scope="module")
def ref_out(tmp_path_factory):
    header = f"N_SUITE = {len(SUITE)}\nCERT = {CERT!r}\nBAD = {list(BAD)!r}\n"
    return run_reference(header + REFERENCE, _inputs(),
                         tmp_path_factory.mktemp("dual_pivot"))


def _same_cert(got, jax, prefix, what):
    for k in CERT:
        g, want = np.asarray(getattr(got, k)), jax[prefix + k]
        assert g.dtype == want.dtype, (what, k)
        np.testing.assert_array_equal(g, want, err_msg=f"{what}: {k}")


def _exact(g):
    _, opt = ref.exact_mwpm(g.to_dense().astype(np.float32),
                            g.structure_dense())
    return float(opt)


@pytest.mark.parametrize("i", range(len(SUITE)), ids=[n for n, _ in SUITE])
def test_certificate_matches_jax_and_is_sound(ref_out, i):
    name, g = SUITE[i]
    p = MatchingProblem.from_graph(g, device="cpu")
    for tag, opts in (("", None), ("cut_", SolveOptions(max_iter=0))):
        r = solve(p, opts)
        np.testing.assert_array_equal(r.mate_row.numpy(),
                                      ref_out[f"s{i}__{tag}mr"])
        cert = certify(p, r)
        _same_cert(cert, ref_out, f"s{i}__{tag}", f"{name} {tag}")
        # the JAX suite's claims, on the port's certificate
        opt = _exact(g)
        scale = max(1.0, abs(opt))
        assert cert.upper_bound >= opt - 1e-6 * scale
        assert cert.weight <= cert.upper_bound + 1e-6 * scale
        if abs(cert.weight - opt) <= 1e-5 * scale:
            assert cert.tight and cert.ratio_bound == 1.0
        else:
            assert not cert.tight and 0.0 < cert.ratio_bound < 1.0
        m = g.row < g.n
        slack = cert.u[g.row[m]] + cert.v[g.col[m]] - g.val[m].astype(
            np.float64)
        assert slack.min() >= -1e-9 * scale
        u, v = cert.potentials()
        u += 1.0  # a copy: the certificate keeps its own
        np.testing.assert_array_equal(cert.u + 1.0, u)
        np.testing.assert_array_equal(cert.v, v)


def test_batched_certify_matches_jax_and_per_instance(ref_out):
    pb = MatchingProblem.stack(BATCH, device="cpu")
    certs = certify(pb, solve(pb))
    assert len(certs) == 3
    for i, (g, cert) in enumerate(zip(BATCH, certs)):
        _same_cert(cert, ref_out, f"b{i}__", f"batch lane {i}")
        p1 = MatchingProblem.from_graph(g, device="cpu")
        alone = certify(p1, solve(p1))
        assert cert.upper_bound == alone.upper_bound
        assert cert.tight == alone.tight


@pytest.mark.parametrize("name", list(BAD))
def test_rejections_match_jax(ref_out, name):
    row, col, val, n, mr = BAD[name]
    with pytest.raises(ValueError) as e:
        dual_certificate(row, col, val, n, mr)
    assert str(e.value) == str(ref_out[f"bad_{name}"])


def test_ratio_bound_of_an_invalid_certificate_raises():
    cert = dual.DualCertificate(u=np.zeros(2), v=np.zeros(2), weight=-3.0,
                                upper_bound=-1.0, tight=False, rounds=2)
    assert not cert.bound_valid and cert.ratio_bound_or() is None
    with pytest.raises(ValueError, match="no valid ratio bound"):
        cert.ratio_bound


@pytest.mark.parametrize("metric", ["product", "sum"])
def test_batched_pivot_permutations_match_jax(ref_out, metric):
    mats = [a for a, _ in MATS]
    perms, iters = pivot.batched_pivot_permutations(mats, metric=metric,
                                                    device="cpu")
    np.testing.assert_array_equal(perms, ref_out[f"perm_{metric}"])
    np.testing.assert_array_equal(iters, ref_out[f"iters_{metric}"])
    assert perms.dtype == np.int64
    grid = make_grid(1, 1, device="cpu")
    gperms, giters = pivot.batched_pivot_permutations(mats, metric=metric,
                                                      grid=grid)
    np.testing.assert_array_equal(gperms, perms)
    np.testing.assert_array_equal(giters, iters)


def test_static_pivot_solve_matches_jax(ref_out):
    mats, bs = [a for a, _ in MATS], [b for _, b in MATS]
    xs, _ = pivot.static_pivot_solve_batched(mats, bs, device="cpu")
    np.testing.assert_array_equal(xs, ref_out["xs"])
    for x in xs:
        assert pivot.relative_error(x, np.ones(len(x))) <= 1e-10
    a_s, d_r, d_c = pivot.equilibrate(mats[0])
    for got, k in ((a_s, "eq_a"), (d_r, "eq_r"), (d_c, "eq_c")):
        np.testing.assert_array_equal(got, ref_out[k])
    ell, u = pivot.lu_nopivot(mats[0][ref_out["perm_product"][0]])
    np.testing.assert_array_equal(ell, ref_out["lu_l"])
    np.testing.assert_array_equal(u, ref_out["lu_u"])
    rr, cc = np.nonzero(a_s)
    g = graph.from_coo(rr.astype(np.int32), cc.astype(np.int32),
                       np.abs(a_s[rr, cc]).astype(np.float32), a_s.shape[0])
    np.testing.assert_array_equal(pivot.log_transformed(g).val,
                                  ref_out["log_val"])


def test_pivot_refusals():
    with pytest.raises(ValueError, match="unknown pivot metric"):
        pivot.batched_pivot_permutations([np.eye(3)], metric="max",
                                         device="cpu")
    with pytest.raises(ValueError, match="share n"):
        pivot.batched_pivot_permutations([np.eye(3), np.eye(4)],
                                         device="cpu")
    with pytest.raises(ZeroDivisionError, match="zero pivot"):
        pivot.lu_nopivot(np.array([[0.0, 1.0], [1.0, 0.0]]))


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: solve() runs the AWAC kernels "
                    "there (CUDA C++ for sm_90a, no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pivots_and_certificates_on_the_card_equal_the_cpu(cuda):
    mats = [a for a, _ in MATS]
    for metric in ("product", "sum"):
        got = pivot.batched_pivot_permutations(mats, metric=metric)
        want = pivot.batched_pivot_permutations(mats, metric=metric,
                                                device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    pb = MatchingProblem.stack(BATCH)
    assert pb.device.type == "cuda"
    pc = MatchingProblem.stack(BATCH, device="cpu")
    for a, b in zip(certify(pb, solve(pb)), certify(pc, solve(pc))):
        assert (a.upper_bound, a.tight, a.rounds) == (b.upper_bound, b.tight,
                                                      b.rounds)
