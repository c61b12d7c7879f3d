"""The port's gradient compression (``training.grad_compression``)
against the JAX package's, on the CPU.

  - ``quantize_int8`` (halves that round to even included) and
    ``dequantize_int8``: payloads and scales bit for bit;
  - ``topk_sparsify`` with ties at the k-th magnitude (``jax.lax.top_k``
    keeps the lowest indices), and 200 error-feedback steps of
    ``compress_topk`` on a tree: every step's output and residual bit for
    bit;
  - ``compress_int8_psum`` over spawned gloo ranks (``tests/
    _torch_grid.py``): the 4 ranks of a 4x1 grid (its column group), and
    each row group of a 2x2 grid, against JAX's inside ``shard_map`` over
    the axis ``"data"`` of a 4-device mesh and of a 2x2 mesh whose rows
    are the grid's, on the same per-rank gradients, for 3 steps. Payloads,
    int32 sums, scales and shared scales bit for bit; the decoded means
    and the residuals to rtol 1e-6, any departure printed with its index
    and both values.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_grid import run_grid  # noqa: E402
from repro_torch.training import grad_compression as gc  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

STEPS_TOPK = 200
K_FRAC = 0.05
PSUM_STEPS = 3
FLOAT_RTOL = 1e-6
LEAVES = {"w": (6, 5), "b": (7,)}

REFERENCE = """
import json

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.training import grad_compression as gc

for i in range(int(IN["n_quant"])):
    q, scale = jax.jit(gc.quantize_int8)(jnp.asarray(IN[f"quant{i}"]))
    OUT[f"quant{i}__q"], OUT[f"quant{i}__scale"] = q, scale
    OUT[f"quant{i}__deq"] = gc.dequantize_int8(q, scale)

qz = jax.jit(gc.quantize_int8)
scales = [qz(jnp.asarray(x))[1] for x in IN["many"]]
OUT["many__scale"] = np.array(scales, np.float32)

for i in range(int(IN["n_ties"])):
    kept, res = gc.topk_sparsify(jnp.asarray(IN[f"ties{i}"]),
                                 float(IN["ties_frac"][i]))
    OUT[f"ties{i}__kept"], OUT[f"ties{i}__res"] = kept, res

# error-feedback top-k over 200 steps of a tree
tree = lambda s: {"w": jnp.asarray(IN["topk_w"][s]),
                  "b": jnp.asarray(IN["topk_b"][s])}
state = gc.init_state(tree(0))
step = jax.jit(lambda g, st: gc.compress_topk(g, st, float(IN["k_frac"])))
for s in range(int(IN["topk_steps"])):
    kept, state = step(tree(s), state)
    for k in ("w", "b"):
        OUT[f"topk{s}__{k}__kept"] = kept[k]
        OUT[f"topk{s}__{k}__res"] = state.residual[k]

# compress_int8_psum inside shard_map over "data"
for case, shape, names in (("rows", (4,), ("data",)),
                           ("row", (2, 2), ("row", "data"))):
    mesh = jax.make_mesh(shape, names)
    spec = P(*names)
    lead = len(shape)

    def per_rank(g, r):
        g = {k: v.reshape(v.shape[lead:]) for k, v in g.items()}
        r = {k: v.reshape(v.shape[lead:]) for k, v in r.items()}
        mean, st = gc.compress_int8_psum(g, gc.CompressedState(r), "data")
        out = {}
        for k in g:
            q, scale = gc.quantize_int8(g[k] + r[k])
            out[k] = dict(payload=q, scale=scale, mean=mean[k],
                          residual=st.residual[k],
                          summed=jax.lax.psum(q.astype(jnp.int32), "data"),
                          shared_scale=jax.lax.pmax(scale, "data"))
        return jax.tree.map(lambda x: x.reshape((1,) * lead + x.shape), out)

    fn = jax.jit(jax.shard_map(per_rank, mesh=mesh, in_specs=(spec, spec),
                               out_specs=spec, check_vma=False))
    ranks = int(np.prod(shape))
    res = {k: jnp.zeros(shape + IN[f"psum_{k}"].shape[2:], jnp.float32)
           for k in ("w", "b")}
    for s in range(int(IN["psum_steps"])):
        g = {k: jnp.asarray(IN[f"psum_{k}"][:, s].reshape(
                shape + IN[f"psum_{k}"].shape[2:])) for k in ("w", "b")}
        out = fn(g, res)
        res = {k: out[k]["residual"] for k in ("w", "b")}
        for k in ("w", "b"):
            for f, v in out[k].items():
                v = np.asarray(v)
                OUT[f"{case}{s}__{k}__{f}"] = v.reshape((ranks,) + v.shape[lead:])
"""


def _quant_inputs():
    rng = np.random.default_rng(0)
    return [
        # scale 1 + 1e-12 rounds to 1.0 in float32: the halves round to
        # even (2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 126.5 -> 126)
        np.array([127.0, 2.5, -3.5, 0.5, -0.5, 126.5, 1.5], np.float32),
        rng.normal(size=(33, 17)).astype(np.float32),
        (rng.normal(size=1000) * 1e-6).astype(np.float32),
        np.zeros(5, np.float32),
        (rng.standard_cauchy(size=(64,)) * 3).astype(np.float32),
    ]


def _many_inputs():
    """300 vectors over ten decades of magnitude: the scale's rounding
    differs between a true division and XLA's fused product in about one
    case of seven."""
    rng = np.random.default_rng(4)
    mag = 10.0 ** rng.integers(-6, 3, size=(300, 1))
    return (rng.normal(size=(300, 30)) * mag).astype(np.float32)


def _tie_inputs():
    rng = np.random.default_rng(1)
    x = rng.integers(-3, 4, size=(40,)).astype(np.float32)
    y = np.where(rng.random((8, 9)) < 0.5, 2.0, -2.0).astype(np.float32)
    z = np.ones(13, np.float32)
    return [(x, 0.1), (x, 0.3), (y, 0.25), (z, 0.4), (x.reshape(5, 8), 0.01)]


def _topk_inputs():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(STEPS_TOPK, 12, 10)).astype(np.float32)
    b = rng.normal(size=(STEPS_TOPK, 9)).astype(np.float32)
    # ties: some steps' gradients on a coarse grid of values
    w[::7] = np.round(w[::7])
    return w, b


def _psum_inputs():
    rng = np.random.default_rng(3)
    out = {}
    for k, shape in LEAVES.items():
        scales = 10.0 ** rng.integers(-4, 2, size=(4, PSUM_STEPS, 1))
        g = rng.normal(size=(4, PSUM_STEPS, *shape)) * scales.reshape(
            (4, PSUM_STEPS) + (1,) * len(shape))
        out[k] = g.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    quant = _quant_inputs()
    ties = _tie_inputs()
    w, b = _topk_inputs()
    psum = _psum_inputs()
    inputs = dict(n_quant=np.array(len(quant)), n_ties=np.array(len(ties)),
                  ties_frac=np.array([f for _, f in ties]),
                  topk_w=w, topk_b=b, k_frac=np.array(K_FRAC),
                  topk_steps=np.array(STEPS_TOPK),
                  psum_steps=np.array(PSUM_STEPS), many=_many_inputs(),
                  **{f"quant{i}": x for i, x in enumerate(quant)},
                  **{f"ties{i}": x for i, (x, _) in enumerate(ties)},
                  **{f"psum_{k}": v for k, v in psum.items()})
    return run_reference(REFERENCE, inputs,
                         tmp_path_factory.mktemp("grad_compression"),
                         n_devices=4)


def _same_bits(got, want, what):
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), (
        f"{what}: differs at {np.argwhere(got != want)[:5].tolist()}")


def _close(got, want, what):
    """rtol FLOAT_RTOL; prints every entry that is not bit-identical."""
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    for idx in np.argwhere(got != want)[:10]:
        i = tuple(idx)
        print(f"{what}{list(i)}: port {got[i]!r}, JAX {want[i]!r}")
    np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0,
                               err_msg=what)


@pytest.mark.parametrize("i", range(len(_quant_inputs())))
def test_quantize_int8_equals_jax(ref, i):
    q, scale = gc.quantize_int8(torch.from_numpy(_quant_inputs()[i]))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    _same_bits(q.numpy(), ref[f"quant{i}__q"], "payload")
    _same_bits(scale.numpy(), ref[f"quant{i}__scale"], "scale")
    _same_bits(gc.dequantize_int8(q, scale).numpy(), ref[f"quant{i}__deq"],
               "dequantized")


def test_scales_follow_the_compiled_reference(ref):
    """Every scale equals the jitted JAX step's, ``fma(max|x|, f32(1/127),
    1e-12)``; op-by-op division then addition misses some of them."""
    many = _many_inputs()
    got = np.array([float(gc.quantize_int8(torch.from_numpy(x))[1])
                    for x in many], np.float32)
    _same_bits(got, ref["many__scale"], "scales")
    m = np.abs(many).max(axis=1)
    naive = (m / np.float32(127.0) + np.float32(1e-12)).astype(np.float32)
    assert (naive != got).sum() >= 10


def test_round_half_to_even():
    q, scale = gc.quantize_int8(torch.from_numpy(_quant_inputs()[0]))
    assert float(scale) == 1.0
    assert q.tolist() == [127, 2, -4, 0, 0, 126, 2]


@pytest.mark.parametrize("i", range(len(_tie_inputs())))
def test_topk_sparsify_with_ties_equals_jax(ref, i):
    x, frac = _tie_inputs()[i]
    kept, res = gc.topk_sparsify(torch.from_numpy(x), frac)
    _same_bits(kept.numpy(), ref[f"ties{i}__kept"], "kept")
    _same_bits(res.numpy(), ref[f"ties{i}__res"], "residual")


def test_topk_ties_go_to_the_lowest_indices():
    x = torch.tensor([1.0, -2.0, 2.0, 0.0, -2.0, 3.0])
    assert gc.topk_indices(x, 0.5).tolist() == [1, 2, 5]
    assert gc.topk_indices(x, 0.01).tolist() == [5]  # k = max(1, 0)
    kept, res = gc.topk_sparsify(x, 0.5)
    assert kept.tolist() == [0.0, -2.0, 2.0, 0.0, 0.0, 3.0]
    assert torch.equal(kept + res, x)


def test_two_hundred_topk_steps_equal_jax(ref):
    w, b = _topk_inputs()
    state = gc.init_state({"w": torch.zeros(w.shape[1:]),
                           "b": torch.zeros(b.shape[1:])})
    for s in range(STEPS_TOPK):
        g = {"w": torch.from_numpy(w[s]), "b": torch.from_numpy(b[s])}
        kept, state = gc.compress_topk(g, state, K_FRAC)
        for k in ("w", "b"):
            _same_bits(kept[k].numpy(), ref[f"topk{s}__{k}__kept"],
                       f"step {s} {k} kept")
            _same_bits(state.residual[k].numpy(), ref[f"topk{s}__{k}__res"],
                       f"step {s} {k} residual")


def test_trees_keep_their_structure():
    g = {"b": torch.ones(3), "a": (torch.full((2,), 2.0), [torch.zeros(1)])}
    st = gc.init_state(g)
    kept, st2 = gc.compress_topk(g, st, 0.5)
    assert set(kept) == {"a", "b"} and isinstance(kept["a"], tuple)
    assert isinstance(kept["a"][1], list)
    assert gc.tree_leaves(st2.residual)[0].shape == (2,)  # "a" sorts first


_INT8_FIELDS = ("payload", "scale", "summed", "shared_scale")


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    psum = _psum_inputs()
    out = {}
    for case, (pr, pc) in (("rows", (4, 1)), ("row", (2, 2))):
        out[case] = run_grid(pr, pc, [("psum", "int8_psum", dict(
            grads=psum, steps=PSUM_STEPS, axis=case))],
            tmp_path_factory.mktemp(f"int8_{case}"))
    return out


@pytest.mark.parametrize("case", ["rows", "row"])
def test_compress_int8_psum_over_gloo_equals_shard_map(ref, grids, case):
    for rank, res in enumerate(grids[case]):
        out = res["psum"]
        assert not (isinstance(out, tuple) and out[0] == "raised"), out
        for s in range(PSUM_STEPS):
            for k in LEAVES:
                got = out[s][k]
                for f in _INT8_FIELDS:
                    _same_bits(got[f], ref[f"{case}{s}__{k}__{f}"][rank],
                               f"rank {rank} step {s} {k} {f}")
                for f in ("mean", "residual"):
                    _close(got[f], ref[f"{case}{s}__{k}__{f}"][rank],
                           f"rank {rank} step {s} {k} {f}")
    # the groups really summed: each payload sum is over the group's ranks
    per_rank = [r["psum"][0]["w"]["payload"].astype(np.int32)
                for r in grids[case]]
    want = (sum(per_rank) if case == "rows" else per_rank[0] + per_rank[1])
    np.testing.assert_array_equal(grids[case][0]["psum"][0]["w"]["summed"],
                                  want)


@pytest.mark.gpu
def test_card_equals_the_cpu_bit_for_bit():
    """quantize_int8, the residual's single rounding and top-k on the card
    give the host CPU's bits (the card's division by a Python number would
    not: it multiplies by the reciprocal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    many = torch.from_numpy(_many_inputs())
    for x in many:
        qc, sc = gc.quantize_int8(x)
        qg, sg = gc.quantize_int8(x.cuda())
        assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
    w, _ = _topk_inputs()
    for s in range(0, STEPS_TOPK, 7):
        x = torch.from_numpy(w[s])
        assert torch.equal(gc.topk_indices(x.cuda(), K_FRAC).cpu(),
                           gc.topk_indices(x, K_FRAC))
