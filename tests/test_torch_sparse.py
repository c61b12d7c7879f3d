"""The port's sparse primitives against ``repro.sparse`` on identical inputs:
segment reductions with ties, empty segments and -inf entries, the
lexicographic and windowed binary searches, and the CSR row pointers.
Every output is compared exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graph  # noqa: E402
from repro_torch.sparse import csr, ops  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

B, M, S = 3, 400, 41  # instances, entries per instance, segments


def _inputs():
    rng = np.random.default_rng(7)
    # few distinct values: plenty of ties inside a segment; some -inf
    values = rng.integers(0, 5, (B, M)).astype(np.float32) / 4
    values[rng.random((B, M)) < 0.1] = -np.inf
    payload = rng.permutation(B * M).reshape(B, M).astype(np.int32)
    # segment S - 1 is the dump segment; segments 3 and 17 stay empty
    seg = rng.integers(0, S, (B, M)).astype(np.int32)
    seg[(seg == 3) | (seg == 17)] = S - 1
    gs = [graph.generate(90, avg_degree=5.0, kind=k, seed=i)
          for i, k in enumerate(("uniform", "powerlaw", "banded"))]
    cap = max(g.capacity for g in gs)
    row = np.full((B, cap), 90, np.int32)
    col = np.full((B, cap), 90, np.int32)
    for b, g in enumerate(gs):
        row[b, :g.capacity], col[b, :g.capacity] = g.row, g.col
    # queries: half present edges, half random pairs
    k = 300
    pick = rng.integers(0, gs[0].nnz, k // 2)
    q_r = np.concatenate([gs[0].row[pick],
                          rng.integers(0, 91, k // 2)]).astype(np.int32)
    q_c = np.concatenate([gs[0].col[pick],
                          rng.integers(0, 91, k // 2)]).astype(np.int32)
    return dict(values=values, payload=payload, seg=seg, row=row, col=col,
                q_r=q_r, q_c=q_c, n=np.array(90))


INPUTS = _inputs()

REFERENCE = """
import jax.numpy as jnp
from repro.sparse import csr, ops

v, p, s = (jnp.asarray(IN[k]) for k in ("values", "payload", "seg"))
S = int(IN["S"])
OUT["smp_max"], OUT["smp_pay"] = ops.segment_max_with_payload(v[0], p[0], s[0], S)
OUT["bsmp_max"], OUT["bsmp_pay"] = ops.batched_segment_max_with_payload(v, p, s, S)
OUT["bsmin"] = ops.batched_segment_min(p, s, S)
import jax
OUT["smin"] = jax.ops.segment_min(p[0], s[0], num_segments=S)
row, col = jnp.asarray(IN["row"]), jnp.asarray(IN["col"])
n = int(IN["n"])
OUT["lex_pos"], OUT["lex_found"] = ops.lex_searchsorted(
    row[0], col[0], jnp.asarray(IN["q_r"]), jnp.asarray(IN["q_c"]))
OUT["rp"] = csr.row_ptr_from_sorted(row[0], n)
brp = csr.batched_row_ptr_from_sorted(row, n)
OUT["brp"] = brp
ws = csr.window_depth(csr.max_row_nnz(np.asarray(row), n))
OUT["ws"] = np.array(ws)
OUT["mrn0"] = np.array(csr.max_row_nnz(np.asarray(row[0]), n))
qi = jnp.clip(jnp.asarray(IN["q_r"]), 0, n - 1)
OUT["win_pos"], OUT["win_found"] = ops.searchsorted_in_window(
    col[0], jnp.asarray(IN["q_c"]), brp[0][qi], brp[0][qi + 1], n_steps=ws)
lo = jnp.broadcast_to(brp[:, :n], (row.shape[0], n))
OUT["bwin_pos"], OUT["bwin_found"] = ops.batched_searchsorted_in_window(
    col, jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[::-1], lo.shape),
    lo, brp[:, 1:n + 1], n_steps=ws)
OUT["wd"] = np.array([csr.window_depth(k) for k in range(0, 70)])
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE, {**INPUTS, "S": np.array(S)},
                         tmp_path_factory.mktemp("sparse"))


def _t(name):
    return torch.from_numpy(INPUTS[name])


def _eq(got, want):
    np.testing.assert_array_equal(torch.as_tensor(got).numpy(), want)


def test_segment_max_with_payload(ref):
    mx, pay = ops.segment_max_with_payload(_t("values")[0], _t("payload")[0],
                                           _t("seg")[0], S)
    _eq(mx, ref["smp_max"])
    _eq(pay, ref["smp_pay"])
    assert (ref["smp_pay"][[3, 17]] == -1).all()  # empty segments


def test_batched_segment_max_with_payload(ref):
    mx, pay = ops.batched_segment_max_with_payload(
        _t("values"), _t("payload"), _t("seg"), S)
    _eq(mx, ref["bsmp_max"])
    _eq(pay, ref["bsmp_pay"])


def test_segment_min_and_batched(ref):
    _eq(ops.segment_min(_t("payload")[0], _t("seg")[0], S), ref["smin"])
    _eq(ops.batched_segment_min(_t("payload"), _t("seg"), S), ref["bsmin"])
    assert ref["smin"][3] == np.iinfo(np.int32).max  # empty-segment identity


def test_segment_min_of_live_entries(ref):
    """With a ``live`` mask the masked entries reach no segment: the dump
    segment's entries masked, every other segment equals JAX's min and
    the dump holds the identity; a random mask equals a numpy min over
    the live entries alone."""
    seg, pay = _t("seg"), _t("payload")
    live = seg != S - 1
    got = ops.batched_segment_min(pay, seg, S, live=live)
    _eq(got[:, :S - 1], ref["bsmin"][:, :S - 1])
    assert (got[:, S - 1] == np.iinfo(np.int32).max).all()
    _eq(ops.segment_min(pay[0], seg[0], S, live=live[0])[:S - 1],
        ref["smin"][:S - 1])
    mask = np.random.default_rng(3).random(seg.shape) < 0.5
    want = np.full((B, S), np.iinfo(np.int32).max, np.int32)
    for b in range(B):
        np.minimum.at(want[b], INPUTS["seg"][b][mask[b]],
                      INPUTS["payload"][b][mask[b]])
    _eq(ops.batched_segment_min(pay, seg, S, live=torch.from_numpy(mask)),
        want)


def test_lex_searchsorted(ref):
    pos, found = ops.lex_searchsorted(_t("row")[0], _t("col")[0], _t("q_r"),
                                      _t("q_c"))
    _eq(pos, ref["lex_pos"])
    _eq(found, ref["lex_found"])
    assert ref["lex_found"].any() and not ref["lex_found"].all()


def test_row_ptr_and_window_depth(ref):
    n = int(INPUTS["n"])
    _eq(csr.row_ptr_from_sorted(_t("row")[0], n), ref["rp"])
    _eq(csr.batched_row_ptr_from_sorted(_t("row"), n), ref["brp"])
    ws = csr.window_depth(csr.max_row_nnz(_t("row"), n))
    assert ws == int(ref["ws"])
    assert csr.max_row_nnz(_t("row")[0], n) == int(ref["mrn0"])
    _eq(np.array([csr.window_depth(k) for k in range(0, 70)]), ref["wd"])


def test_windowed_searches(ref):
    n = int(INPUTS["n"])
    brp = csr.batched_row_ptr_from_sorted(_t("row"), n)
    ws = int(ref["ws"])
    qi = _t("q_r").clamp(0, n - 1).long()
    pos, found = ops.searchsorted_in_window(_t("col")[0], _t("q_c"),
                                            brp[0][qi], brp[0][qi + 1],
                                            n_steps=ws)
    _eq(pos, ref["win_pos"])
    _eq(found, ref["win_found"])
    lo = brp[:, :n]
    q = torch.arange(n, dtype=torch.int32).flip(0).expand(lo.shape)
    pos, found = ops.batched_searchsorted_in_window(
        _t("col"), q, lo, brp[:, 1:n + 1], n_steps=ws)
    _eq(pos, ref["bwin_pos"])
    _eq(found, ref["bwin_found"])
