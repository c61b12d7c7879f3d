"""The port's 2D partition (``sparse.partition``) and its tie-break argmax
(``sparse.ops.segment_argmax_tie``) against the JAX package.

The partition is numpy on both sides: every array (rows, cols, weights,
block counts) must be equal, on grids of several shapes, for lex-sorted
input (the engine's fast path) and shuffled input, and ``plan_block_cap``
must come from the true block occupancy. The argmax runs on tie-heavy
inputs with masked (-inf) entries, against JAX under x64 (its packed
single pass) and without (its three-pass reference).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import batch, graph  # noqa: E402
from repro_torch.sparse.ops import (  # noqa: E402
    batched_segment_argmax_tie,
    segment_argmax_tie,
)
from repro_torch.sparse.partition import (  # noqa: E402
    block_occupancy,
    partition_coo_2d,
    partition_coo_2d_batched,
    plan_block_cap,
)
from test_torch_harness import run_reference  # noqa: E402

GRIDS = [(1, 1), (2, 2), (2, 4), (4, 2), (3, 5)]
FIELDS = ("row", "col", "val", "nnz")


def _skewed_batch(n=16, cap=40):
    """One dense row (all its edges in a single grid row) beside a plain
    diagonal: the case a uniform nnz / (pr * pc) estimate undercounts."""
    row = np.full((2, cap), n, np.int32)
    col = np.full((2, cap), n, np.int32)
    val = np.zeros((2, cap), np.float32)
    r0 = np.concatenate([np.zeros(n, np.int32),
                         np.arange(1, n, dtype=np.int32)])
    c0 = np.concatenate([np.arange(n, dtype=np.int32),
                         np.arange(1, n, dtype=np.int32)])
    order = np.lexsort((c0, r0))
    row[0, : r0.size], col[0, : r0.size] = r0[order], c0[order]
    val[0, : r0.size] = 0.5
    row[1, :n] = col[1, :n] = np.arange(n, dtype=np.int32)
    val[1, :n] = 0.5
    return row, col, val


def _batches():
    gs = [graph.generate(45, avg_degree=4.0 + i, kind=k, seed=80 + i)
          for i, k in enumerate(graph.SUITE_KINDS)]
    row, col, val = (x.numpy() for x in batch.stack_graphs(gs, device="cpu"))
    # the same edges out of order (padding kept last): the general sort
    rng = np.random.default_rng(1)
    shuffled = [a.copy() for a in (row, col, val)]
    for i in range(row.shape[0]):
        m = int((row[i] < 45).sum())
        perm = rng.permutation(m)
        for a in shuffled:
            a[i, :m] = a[i, :m][perm]
    return {"suite": (row, col, val, 45), "shuffled": (*shuffled, 45),
            "skewed": (*_skewed_batch(), 16)}


BATCHES = _batches()


def _argmax_cases():
    """Tie-heavy values (3 distinct, some -inf), ties in ``tie`` too, and
    a dump segment, as the engine feeds them."""
    out = {}
    for i, (m, segs) in enumerate(((200, 17), (1000, 40), (64, 64))):
        rng = np.random.default_rng(90 + i)
        v = rng.choice(np.array([0.25, 0.5, 1.0, -np.inf], np.float32), m,
                       p=[0.3, 0.3, 0.2, 0.2])
        tie = rng.integers(0, 6, m).astype(np.int32)
        seg = rng.integers(0, segs + 1, m).astype(np.int32)
        v[seg == segs] = -np.inf  # the caller's dump segment is masked
        out[f"a{i}"] = (v, tie, seg, segs + 1)
    return out


ARGMAX = _argmax_cases()
B_ARGMAX = tuple(np.stack([ARGMAX["a0"][k], ARGMAX["a0"][k][::-1]])
                 for k in range(3)) + (ARGMAX["a0"][3],)

REFERENCE = """
import jax
import jax.numpy as jnp
from repro.sparse import ops
from repro.sparse.partition import (block_occupancy, partition_coo_2d,
                                    partition_coo_2d_batched, plan_block_cap)

for name in BATCHES:
    row, col, val = (IN[f"{name}__{k}"] for k in ("row", "col", "val"))
    n = int(IN[name + "__n"])
    for pr, pc in GRIDS:
        key = f"{name}__{pr}x{pc}__"
        p = partition_coo_2d_batched(row, col, val, n, pr, pc)
        for f in FIELDS:
            OUT[key + "b_" + f] = getattr(p, f)
        OUT[key + "cap"] = np.array(p.cap)
        OUT[key + "plan"] = np.array(plan_block_cap(row, col, n, pr, pc))
        OUT[key + "occ"] = block_occupancy(row, col, n, pr, pc)
        m = row[0] < n
        q = partition_coo_2d(row[0][m], col[0][m], val[0][m], n, pr, pc)
        for f in FIELDS:
            OUT[key + "s_" + f] = getattr(q, f)

for name in ARGMAX:
    v, t, s = (jnp.asarray(IN[f"{name}__{k}"]) for k in ("v", "t", "s"))
    k = int(IN[name + "__k"])
    with jax.experimental.enable_x64():
        OUT[name + "__x64"] = jnp.stack(
            [x.astype(jnp.float32)
             for x in ops.segment_argmax_tie(v, t, s, k)])
    OUT[name + "__plain"] = jnp.stack(
        [x.astype(jnp.float32) for x in ops.segment_argmax_tie(v, t, s, k)])
v, t, s = (jnp.asarray(IN[f"b__{k}"]) for k in ("v", "t", "s"))
with jax.experimental.enable_x64():
    g, i = ops.batched_segment_argmax_tie(v, t, s, int(IN["b__k"]))
OUT["b__max"], OUT["b__idx"] = g, i
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {}
    for name, (row, col, val, n) in BATCHES.items():
        inputs.update({f"{name}__row": row, f"{name}__col": col,
                       f"{name}__val": val, f"{name}__n": np.array(n)})
    for name, (v, t, s, k) in ARGMAX.items():
        inputs.update({f"{name}__v": v, f"{name}__t": t, f"{name}__s": s,
                       f"{name}__k": np.array(k)})
    inputs.update({"b__v": B_ARGMAX[0], "b__t": B_ARGMAX[1],
                   "b__s": B_ARGMAX[2], "b__k": np.array(B_ARGMAX[3])})
    header = (f"BATCHES = {list(BATCHES)!r}\nGRIDS = {GRIDS!r}\n"
              f"FIELDS = {FIELDS!r}\nARGMAX = {list(ARGMAX)!r}\n")
    return run_reference(header + REFERENCE, inputs,
                         tmp_path_factory.mktemp("partition"))


def _equal(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", list(BATCHES))
def test_partition_matches_jax(ref, name, grid):
    row, col, val, n = BATCHES[name]
    pr, pc = grid
    key = f"{name}__{pr}x{pc}__"
    p = partition_coo_2d_batched(row, col, val, n, pr, pc)
    for f in FIELDS:
        _equal(getattr(p, f), ref[key + "b_" + f], f"batched {f}")
    assert p.cap == int(ref[key + "cap"]) == plan_block_cap(row, col, n, pr,
                                                            pc)
    assert plan_block_cap(row, col, n, pr, pc) == int(ref[key + "plan"])
    _equal(block_occupancy(row, col, n, pr, pc), ref[key + "occ"], "occ")
    m = row[0] < n
    q = partition_coo_2d(row[0][m], col[0][m], val[0][m], n, pr, pc)
    for f in FIELDS:
        _equal(getattr(q, f), ref[key + "s_" + f], f"single {f}")
    assert q.block_of(n - 1, 0) == ((n - 1) // q.br, 0)


def test_block_cap_from_true_occupancy():
    row, col, val = _skewed_batch()
    n = 16
    occ = block_occupancy(row, col, n, 2, 2)
    assert occ.shape == (2, 2, 2)
    # the dense row puts its entries into the two top blocks; the uniform
    # estimate (31 / 4 ~ 8) would truncate
    assert int(occ[0].max()) > (int(occ[0].sum()) + 3) // 4
    cap = plan_block_cap(row, col, n, 2, 2)
    assert cap >= int(occ.max())
    part = partition_coo_2d_batched(row, col, val, n, 2, 2)
    assert part.cap == cap
    assert int((part.row < n).sum()) == int((row < n).sum())
    np.testing.assert_array_equal(part.nnz.sum(axis=(0, 1)),
                                  (row < n).sum(axis=1))


def test_partition_refuses_to_truncate():
    row, col, val = _skewed_batch()
    n = 16
    with pytest.raises(ValueError, match="refusing to truncate"):
        partition_coo_2d_batched(row, col, val, n, 2, 2, cap=8)
    m = row[0] < n
    with pytest.raises(ValueError, match="refusing to truncate"):
        partition_coo_2d(row[0][m], col[0][m], val[0][m], n, 2, 2, cap=8)
    with pytest.raises(ValueError, match="batched"):
        partition_coo_2d_batched(row[0], col[0], val[0], n, 2, 2)


@pytest.mark.parametrize("name", list(ARGMAX))
def test_segment_argmax_tie_matches_jax(ref, name):
    v, t, s, k = ARGMAX[name]
    g, i = segment_argmax_tie(torch.from_numpy(v), torch.from_numpy(t),
                              torch.from_numpy(s), k)
    assert g.dtype == torch.float32 and i.dtype == torch.int32
    got = np.stack([g.numpy(), i.numpy().astype(np.float32)])
    _equal(got, ref[name + "__x64"], "vs the packed pass")
    _equal(got, ref[name + "__plain"], "vs the three passes")
    assert (i.numpy() >= 0).any() and (i.numpy() == -1).any()


def test_batched_segment_argmax_tie_matches_jax(ref):
    v, t, s, k = B_ARGMAX
    g, i = batched_segment_argmax_tie(*(torch.from_numpy(x)
                                        for x in (v, t, s)), k)
    _equal(g.numpy(), ref["b__max"], "max")
    _equal(i.numpy(), ref["b__idx"], "idx")
    # each lane equals its own single call
    for lane in range(2):
        g1, i1 = segment_argmax_tie(*(torch.from_numpy(x[lane])
                                      for x in (v, t, s)), k)
        assert torch.equal(g1, g[lane]) and torch.equal(i1, i[lane])
