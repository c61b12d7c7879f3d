"""K3, the dense cycle-gain tile, against the JAX package on the CPU.

The JAX side runs once per module in a child process
(``test_torch_harness.run_reference``): ``cycle_gain_ref`` (the dense
oracle), ``cycle_gain_padded`` (the Pallas kernel, interpreted, with the
128 x 128 tiles of ``tests/test_kernels.py``) and ``ops.swap_gains`` with
both ``use_kernel`` values. The port's plain version (``cycle_gain_plain``)
and its entries (``ops.cycle_gain_padded``, ``ops.swap_gains``, which on
CPU tensors take the plain version) must give the same gains bit for bit
and the same rows:

  - ``tests/test_kernels.py``'s grid, (m, n) in {(64, 128), (256, 256),
    (300, 200), (8, 640)} x density {0.1, 0.5, 1.0}, with its draws;
  - a tie-heavy case (small integers: many columns reach their max on
    several rows), a case with all-absent columns and rows whose u is
    +inf or -inf (gains of -inf and +inf), and an all-absent tile;
  - ``swap_gains`` at (T, E) = (128, 8) and (300, 60), and a small case
    that pins its reference quirks: the same token and the same expert
    are not excluded, and an affinity of exactly 0.0 is absent.

The ``gpu`` tests hold the CUDA kernel to the plain version on the card,
bit for bit, and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.cycle_gain.cycle_gain import cycle_gain  # noqa: E402
from repro_torch.kernels.cycle_gain.ops import (  # noqa: E402
    cycle_gain_padded,
    swap_gains,
)
from repro_torch.kernels.cycle_gain.ref import cycle_gain_plain  # noqa: E402
from repro_torch.kernels.router_swap import router_swap_plain  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

GRID = [(m, n, d) for m, n in [(64, 128), (256, 256), (300, 200), (8, 640)]
        for d in (0.1, 0.5, 1.0)]
CASES = [f"grid_{m}x{n}_{d}" for m, n, d in GRID] + [
    "ties_200x300", "infs_96x160", "absent_64x128"]
SWAPS = [(128, 8), (300, 60)]

REFERENCE = """
import jax.numpy as jnp
from repro.kernels.cycle_gain import cycle_gain_padded, cycle_gain_ref
from repro.kernels.cycle_gain.ops import swap_gains

for name in [k[:-2] for k in IN if k.endswith("_a")]:
    a, a2, u, v = (jnp.asarray(IN[name + s]) for s in ("_a", "_a2", "_u",
                                                      "_v"))
    OUT[name + "_ref_g"], OUT[name + "_ref_r"] = cycle_gain_ref(a, a2, u, v)
    OUT[name + "_pallas_g"], OUT[name + "_pallas_r"] = cycle_gain_padded(
        a, a2, u, v, tm=128, tn=128)
for name in [k[:-4] for k in IN if k.endswith("_aff")]:
    aff = jnp.asarray(IN[name + "_aff"])
    assign = jnp.asarray(IN[name + "_assign"])
    tok = jnp.take_along_axis(aff, assign[:, None], axis=1)[:, 0]
    OUT[name + "_tok"] = tok
    OUT[name + "_ref_g"], OUT[name + "_ref_r"] = swap_gains(
        aff, assign, tok, use_kernel=False)
    OUT[name + "_pallas_g"], OUT[name + "_pallas_r"] = swap_gains(
        aff, assign, tok, use_kernel=True)
"""


def _grid_case(m, n, density):
    """``tests/test_kernels.py::test_cycle_gain_matches_ref``'s draw."""
    rng = np.random.default_rng(m * 1000 + n + int(density * 10))
    a = rng.uniform(0.1, 1.0, (m, n)) * (rng.random((m, n)) < density)
    a2 = rng.uniform(0.1, 1.0, (m, n)) * (rng.random((m, n)) < density)
    u = rng.uniform(0.0, 1.0, m).astype(np.float32)
    v = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return a.astype(np.float32), a2.astype(np.float32), u, v


def _special_cases():
    rng = np.random.default_rng(11)
    m, n = 200, 300
    ties = tuple(rng.integers(0, 4, s).astype(np.float32)
                 for s in ((m, n), (m, n), m, n))
    m, n = 96, 160
    a, a2, u, v = _grid_case(m, n, 0.3)
    a[:, ::7] = 0.0  # every 7th column absent
    u[5], u[40] = np.inf, -np.inf  # row 5's gains -inf, row 40's +inf
    a[40, ::3] = 0.0  # so that +inf wins only every other present column
    infs = (a, a2, u, v)
    m, n = 64, 128
    absent = (np.zeros((m, n), np.float32), np.zeros((m, n), np.float32),
              np.zeros(m, np.float32), np.zeros(n, np.float32))
    return {"ties_200x300": ties, "infs_96x160": infs,
            "absent_64x128": absent}


def _swap_case(t, e, seed):
    rng = np.random.default_rng(seed)
    aff = rng.normal(size=(t, e)).astype(np.float32)
    assign = rng.integers(0, e, t).astype(np.int32)
    return aff, assign


def _quirk_case():
    """Six tokens on three experts, log-probability-like (negative)
    affinities, so that most real swaps lose; token 0's affinity to
    expert 2 is exactly 0.0 (absent to ``swap_gains``), and a swap of
    tokens 0 and 4 through it would gain."""
    aff = np.array([[-1.0, -3.0, 0.0],
                    [-2.0, -1.0, -4.0],
                    [-3.5, -2.5, -1.0],
                    [-1.5, -2.0, -3.0],
                    [-0.5, -4.0, -2.0],
                    [-2.0, -0.75, -2.5]], np.float32)
    assign = np.array([0, 1, 2, 0, 2, 1], np.int32)
    return aff, assign


def _inputs():
    out = {}
    tiles = {f"grid_{m}x{n}_{d}": _grid_case(m, n, d) for m, n, d in GRID}
    tiles.update(_special_cases())
    for name, arrays in tiles.items():
        for s, x in zip(("_a", "_a2", "_u", "_v"), arrays):
            out[name + s] = x
    for t, e in SWAPS:
        out[f"swap{t}x{e}_aff"], out[f"swap{t}x{e}_assign"] = _swap_case(
            t, e, seed=t + e)
    out["quirk_aff"], out["quirk_assign"] = _quirk_case()
    return out


INPUTS = _inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE, INPUTS, tmp_path_factory.mktemp("k3"))


def _tile(name):
    return tuple(torch.from_numpy(INPUTS[name + s])
                 for s in ("_a", "_a2", "_u", "_v"))


def _swap_inputs(ref, name):
    aff = torch.from_numpy(INPUTS[name + "_aff"])
    assign = torch.from_numpy(INPUTS[name + "_assign"])
    tok = torch.gather(aff, 1, assign.long()[:, None])[:, 0]
    np.testing.assert_array_equal(tok.numpy(), ref[name + "_tok"])
    return aff, assign, tok


def _exact(got, ref, name, which):
    g, r = got
    want_g, want_r = ref[f"{name}_{which}_g"], ref[f"{name}_{which}_r"]
    assert g.dtype == torch.float32 and r.dtype == torch.int32
    # bit for bit: the same float32 words, infinities included
    np.testing.assert_array_equal(g.numpy().view(np.int32),
                                  want_g.view(np.int32))
    np.testing.assert_array_equal(r.numpy(), want_r)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("which", ["ref", "pallas"])
def test_plain_matches_jax(ref, name, which):
    _exact(cycle_gain_plain(*_tile(name)), ref, name, which)


@pytest.mark.parametrize("name", CASES)
def test_padded_matches_jax(ref, name):
    args = _tile(name)
    _exact(cycle_gain_padded(*args), ref, name, "pallas")
    _exact(cycle_gain_padded(*args, use_kernel=False), ref, name, "ref")


def test_cases_cover_ties_infinities_and_empty_columns(ref):
    a, a2, u, v = _tile("ties_200x300")
    w = torch.where((a != 0) & (a2 != 0), a + a2 - u[:, None] - v, -np.inf)
    assert int((w == w.amax(0)).sum(0).gt(1).sum()) > 100  # tied columns
    g, r = ref["infs_96x160_ref_g"], ref["infs_96x160_ref_r"]
    assert np.isposinf(g).any() and (r[np.isposinf(g)] == 40).all()
    assert np.isneginf(g[::7]).all() and (r[::7] == -1).all()
    assert (ref["absent_64x128_ref_r"] == -1).all()
    assert np.isneginf(ref["absent_64x128_ref_g"]).all()


@pytest.mark.parametrize("t,e", SWAPS + [(6, 3)])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_swap_gains_matches_jax(ref, t, e, use_kernel):
    name = "quirk" if (t, e) == (6, 3) else f"swap{t}x{e}"
    got = swap_gains(*_swap_inputs(ref, name), use_kernel=use_kernel)
    _exact(got, ref, name, "ref")
    _exact(got, ref, name, "pallas")


def test_swap_gains_quirks(ref):
    """``swap_gains`` excludes neither the same token nor the same expert,
    and reads an affinity of exactly 0.0 as absent; K4's search
    (``router_swap_plain``) does neither. Pinned on the JAX results."""
    aff, assign, tok = _swap_inputs(ref, "quirk")
    gain = ref["quirk_ref_g"]
    part = ref["quirk_ref_r"]
    same_expert = assign.numpy()[part] == assign.numpy()
    # a token's swap with itself gains exactly 0, so no column's best is
    # below 0, and columns without a positive swap are won by the token
    # itself or a token on its own expert
    assert (gain >= 0).all()
    assert (same_expert[gain == 0]).all() and (gain == 0).sum() >= 3
    # token 0 has expert 0 and affinity 0.0 to expert 2: the swap with
    # token 4 (expert 2) would gain 0 + (-0.5) - (-1) - (-2) = 2.5, but
    # swap_gains never sees it; K4 finds it
    k4_gain, k4_part = router_swap_plain(aff, assign, tok)
    assert int(k4_part[4]) == 0 and float(k4_gain[4]) == 2.5
    assert int(part[4]) != 0 and float(gain[4]) < 2.5
    # and K4 excludes same-expert partners, which swap_gains reports
    assert not (assign[k4_part.long()] == assign)[k4_part >= 0].any()


def test_wrapper_refusals_and_cpu_route():
    a = torch.ones(8, 16)
    u, v = torch.zeros(8), torch.zeros(16)
    reset_launch_counts()
    cycle_gain(a, a, u, v)  # CPU tensors: the plain version
    assert launch_counts()["cycle_gain"] == 0
    with pytest.raises(ValueError, match="a2"):
        cycle_gain(a, a[:, :8], u, v)
    with pytest.raises(ValueError, match="u"):
        cycle_gain(a, a, u.double(), v)
    with pytest.raises(ValueError, match=r"expected a \[M, N\]"):
        cycle_gain(a[0], a[0], u, v)


# ------------------------------- on the card --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 is CUDA C++ for sm_90a and has "
                    "no CPU mode")
    return torch.device("cuda")


def _bits_equal(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_the_card(cuda, name):
    args = tuple(x.to(cuda) for x in _tile(name))
    reset_launch_counts()
    got = cycle_gain_padded(*args)
    torch.cuda.synchronize()
    assert launch_counts()["cycle_gain"] == 1
    _bits_equal(got, cycle_gain_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("t,e", [(2100, 60), (300, 60), (6, 3)])
def test_swap_gains_kernel_matches_plain_on_the_card(cuda, t, e):
    aff, assign = _quirk_case() if (t, e) == (6, 3) else _swap_case(t, e, 3)
    aff, assign = torch.from_numpy(aff).to(cuda), torch.from_numpy(
        assign).to(cuda)
    tok = torch.gather(aff, 1, assign.long()[:, None])[:, 0]
    reset_launch_counts()
    got = swap_gains(aff, assign, tok)
    torch.cuda.synchronize()
    assert launch_counts()["cycle_gain"] == 1
    _bits_equal(got, swap_gains(aff, assign, tok, use_kernel=False))
