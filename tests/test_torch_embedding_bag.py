"""K6, EmbeddingBag, against the JAX package on the CPU.

The JAX side runs once per module in a child process
(``test_torch_harness.run_reference``): ``embedding_bag_ref`` (the
oracle), ``embedding_bag_padded`` (the Pallas kernel, interpreted, with the
tiles of ``tests/test_kernels.py``) and the recsys layer's
``embedding.embedding_bag`` with both ``use_kernel`` values. The port's
plain version (``embedding_bag_plain``), its entry
(``embedding_bag_padded``) and ``models.recsys.embedding.embedding_bag``
(both ``use_kernel`` values; on CPU tensors the kernel's wrapper takes the
plain version) must agree at rtol = atol = 1e-5 (``tests/test_kernels.py``'s
bar: sums in another order):

  - ``tests/test_kernels.py``'s shapes and draws, (B, L, V, D) in
    {(16, 8, 1024, 64), (8, 32, 600, 32), (33, 5, 2000, 128)}, and a
    ragged (7, 3, 100, 4);
  - bags of padding only, which give exactly 0;
  - indices at and above V: the reference's plain path clips them to row
    V - 1, its Pallas kernel gives them no row. The port follows the plain
    path in both its versions; the test pins the JAX disagreement.

The kernel's two routes are chosen by ``plan_route`` from (B, L, V, D)
and the SM count; its CPU tests pin the choice (``serve_p99`` takes route
A, ``serve_bulk`` route B, the boundary at one bag per warp of route B's
grid) and the validity of the parameters at extreme shapes.

The ``gpu`` tests hold the CUDA kernel to the plain version on the card
and skip here: both routes on each side of the boundary, L from 0 to
1,000, V from 10 rows to more than four windows, D from 4 to 256,
repeated indices, bags of padding only (exactly 0), index V, identical
bits from two calls and one launch a call.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag,
    embedding_bag_padded,
    embedding_bag_plain,
)
from repro_torch.kernels.embedding_bag.embedding_bag import (  # noqa: E402
    MAX_SLICES,
    MAX_WINDOWS,
    SWEEP_SMEM,
    SWEEP_WARPS,
    WINDOW_BYTES,
    plan_route,
)
from repro_torch.models.recsys import embedding  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

TOL = 1e-5
SHAPES = [(16, 8, 1024, 64), (8, 32, 600, 32), (33, 5, 2000, 128),
          (7, 3, 100, 4)]
CASES = [f"bags_{b}x{l}_{v}x{d}" for b, l, v, d in SHAPES] + ["padding"]
OUTPUTS = ("ref", "pallas", "inline", "kernel")

REFERENCE = """
import jax.numpy as jnp
from repro.kernels.embedding_bag import embedding_bag_padded, embedding_bag_ref
from repro.models.recsys import embedding as E

for name in [k[:-4] for k in IN if k.endswith("_idx")]:
    idx, w, table = (jnp.asarray(IN[name + s])
                     for s in ("_idx", "_w", "_table"))
    OUT[name + "_ref"] = embedding_bag_ref(idx, w, table)
    OUT[name + "_pallas"] = embedding_bag_padded(idx, w, table, tb=8, tv=256)
    OUT[name + "_inline"] = E.embedding_bag(table, idx, w, use_kernel=False)
    OUT[name + "_kernel"] = E.embedding_bag(table, idx, w, use_kernel=True)
"""


def _bags(b, l, v, d):
    """``tests/test_kernels.py::test_embedding_bag_matches_ref``'s draw."""
    rng = np.random.default_rng(b + l)
    idx = rng.integers(-1, v, (b, l)).astype(np.int32)  # -1 = padding
    w = rng.uniform(0, 1, (b, l)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    return idx, w, table


def _inputs():
    cases = {f"bags_{b}x{l}_{v}x{d}": _bags(b, l, v, d)
             for b, l, v, d in SHAPES}
    # test_kernels.py::test_embedding_bag_all_padding, and a mixed batch
    # whose rows 0 and 3 are padding only
    idx, w, table = _bags(6, 9, 300, 16)
    idx[[0, 3]] = -1
    cases["padding"] = (idx, w, table)
    cases["allpad"] = (np.full((8, 4), -1, np.int32),
                       np.ones((8, 4), np.float32),
                       np.ones((256, 16), np.float32))
    # indices V and V + 5 beside ordinary ones (the reference's quirk)
    idx, w, table = _bags(5, 6, 200, 8)
    idx[0, 1], idx[2, 4], idx[4, 0] = 200, 205, 200
    cases["outofrange"] = (idx, w, table)
    out = {}
    for name, arrays in cases.items():
        for s, x in zip(("_idx", "_w", "_table"), arrays):
            out[name + s] = x
    return out


INPUTS = _inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE, INPUTS, tmp_path_factory.mktemp("k6"))


def _args(name):
    return tuple(torch.from_numpy(INPUTS[name + s])
                 for s in ("_idx", "_w", "_table"))


def _close(got, want):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("which", OUTPUTS)
def test_plain_matches_jax(ref, name, which):
    _close(embedding_bag_plain(*_args(name)), ref[f"{name}_{which}"])


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_recsys_embedding_bag_matches_jax(ref, name, use_kernel):
    idx, w, table = _args(name)
    got = embedding.embedding_bag(table, idx, w, use_kernel=use_kernel)
    _close(got, ref[f"{name}_{'kernel' if use_kernel else 'inline'}"])
    _close(got, ref[f"{name}_ref"])


@pytest.mark.parametrize("name", ["allpad", "padding"])
def test_padding_bags_are_exactly_zero(ref, name):
    idx, w, table = _args(name)
    pad = (idx < 0).all(1)
    assert pad.any()
    for which in OUTPUTS:
        assert (ref[f"{name}_{which}"][pad.numpy()] == 0).all()
    for got in (embedding_bag_plain(idx, w, table),
                embedding_bag_padded(idx, w, table),
                embedding.embedding_bag(table, idx, w, use_kernel=False)):
        assert bool((got[pad] == 0).all())


def test_out_of_range_index_follows_the_reference_clip(ref):
    """JAX's plain path (``embedding_bag_ref``, and ``embedding.
    embedding_bag`` without the kernel) reads an index >= V as row V - 1;
    its Pallas kernel gives it no row. The port clips in its plain version
    and in its kernel."""
    idx, w, table = _args("outofrange")
    clipped = embedding_bag_plain(idx.clamp(max=199), w, table)
    dropped = embedding_bag_plain(torch.where(idx >= 200, -1, idx), w, table)
    for which in ("ref", "inline"):
        _close(clipped, ref[f"outofrange_{which}"])
    for which in ("pallas", "kernel"):
        _close(dropped, ref[f"outofrange_{which}"])
    assert not np.allclose(ref["outofrange_ref"], ref["outofrange_pallas"],
                           rtol=TOL, atol=TOL)
    for got in (embedding_bag_plain(idx, w, table),
                embedding_bag_padded(idx, w, table),
                embedding.embedding_bag(table, idx, w, use_kernel=True),
                embedding.embedding_bag(table, idx, w, use_kernel=False)):
        _close(got, ref["outofrange_ref"])


def test_entry_takes_wider_indices_and_weights():
    idx, w, table = _args("bags_16x8_1024x64")
    want = embedding_bag_plain(idx, w, table)
    wide = idx.long()
    wide[0, 0], wide[1, 1] = -7, 2**40  # padding, and clipped to V - 1
    want_wide = embedding_bag_plain(wide.clamp(-1, 1023), w, table)
    assert torch.equal(embedding_bag_padded(idx.long(), w.double(), table),
                       want)
    assert torch.equal(embedding_bag_padded(wide, w, table), want_wide)


def test_wrapper_refusals_and_cpu_route():
    idx, w, table = _args("bags_16x8_1024x64")
    reset_launch_counts()
    embedding_bag(idx, w, table)  # CPU tensors: the plain version
    assert launch_counts()["embedding_bag"] == 0
    with pytest.raises(ValueError, match="float32 table.*ROADMAP"):
        embedding_bag(idx, w, table.to(torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 4"):
        embedding_bag(idx, w, table[:, :62])
    with pytest.raises(ValueError, match="idx"):
        embedding_bag(idx.long(), w, table)
    with pytest.raises(ValueError, match="w: expected"):
        embedding_bag(idx, w[:, :4], table)


def test_seeded_table():
    gen = torch.Generator().manual_seed(0)
    t = embedding.table(4096, 64, gen=gen)
    assert t.shape == (4096, 64) and t.dtype == torch.float32
    assert abs(float(t.detach().std()) / 0.02 - 1.0) < 0.02
    again = embedding.table(4096, 64, gen=torch.Generator().manual_seed(0))
    assert torch.equal(t, again)
    assert torch.equal(embedding.lookup(t, torch.tensor([3, 0])),
                       t[[3, 0]])


# ---------------------------- the route choice ------------------------------

H100_SMS = 132
P99 = (512, 200, 1_000_448, 64)  # bert4rec's serve_p99 bags, its item table
BULK = (262_144, 200, 1_000_448, 64)  # serve_bulk


def _check_plan(plan, b, l, v, d, sms):
    """Parameters the kernel's C entry takes, and that cover every bag and
    every row."""
    assert plan.route in ("A", "B")
    if plan.route == "A":
        assert 1 <= plan.slices <= MAX_SLICES
        assert plan.slices & (plan.slices - 1) == 0
        assert plan.slices <= max(1, l)
        assert plan.blocks * plan.bags_per_block >= b
        assert plan.scratch_bytes == 0
        return
    assert plan.blocks == sms
    assert b >= plan.blocks * SWEEP_WARPS
    assert plan.passes * plan.blocks * plan.bags_per_block >= b
    assert (plan.passes - 1) * plan.blocks * plan.bags_per_block < b
    assert plan.bags_per_block >= SWEEP_WARPS
    assert 1 <= plan.windows <= MAX_WINDOWS
    assert plan.window_rows & (plan.window_rows - 1) == 0  # a power of two
    assert plan.windows * plan.window_rows >= v
    assert (plan.windows - 1) * plan.window_rows < v
    # within WINDOW_BYTES, unless MAX_WINDOWS windows would not cover V
    fewest = 1 << (math.ceil(v / MAX_WINDOWS) - 1).bit_length()
    assert (plan.window_rows * d * 4 <= WINDOW_BYTES
            or plan.window_rows == fewest)
    assert plan.smem_bytes == plan.bags_per_block * d * 4 <= SWEEP_SMEM
    sort = plan.blocks * plan.bags_per_block * l * 8 if plan.windows > 1 else 0
    assert plan.scratch_bytes >= 16 + sort


def test_route_serve_p99_fills_the_card_with_slices():
    plan = plan_route(*P99, sms=H100_SMS)
    _check_plan(plan, *P99, H100_SMS)
    assert plan.route == "A" and plan.slices == 4
    assert P99[0] * plan.slices >= 8 * H100_SMS  # 8 warps an SM


def test_route_serve_bulk_sweeps_windows_of_the_table():
    plan = plan_route(*BULK, sms=H100_SMS)
    _check_plan(plan, *BULK, H100_SMS)
    assert plan.route == "B"
    assert (plan.windows, plan.passes) == (8, 3)
    assert plan.window_rows * 64 * 4 == 32 * 2**20


@pytest.mark.parametrize("v", [10, 4096, 130_000])
def test_route_b_table_in_one_window_needs_no_sort(v):
    plan = plan_route(262_144, 200, v, 64, sms=H100_SMS)
    _check_plan(plan, 262_144, 200, v, 64, H100_SMS)
    assert plan.route == "B" and plan.windows == 1 and plan.window_rows >= v
    assert plan.scratch_bytes == 16  # the window counter alone


@pytest.mark.parametrize("b,l,v,d", [(1, 0, 10, 4), (1, 1, 10, 4),
                                     (1, 10**6, 10, 4), (3, 10**6, 10**6, 256),
                                     (5000, 0, 10**6, 64),
                                     (5000, 10**5, 10**7, 8),
                                     (10**6, 1, 10**8, 4),
                                     (10**5, 7, 10**7, 1024),
                                     (10**5, 7, 10**7, 65_536)])
def test_route_extreme_shapes_give_valid_parameters(b, l, v, d):
    plan = plan_route(b, l, v, d, sms=H100_SMS)
    _check_plan(plan, b, l, v, d, H100_SMS)


@pytest.mark.parametrize("sms", [H100_SMS, 114, 8])
def test_route_boundary_is_one_bag_per_warp_of_route_b(sms):
    b = sms * SWEEP_WARPS
    below = plan_route(b - 1, 200, 1_000_448, 64, sms=sms)
    at = plan_route(b, 200, 1_000_448, 64, sms=sms)
    _check_plan(below, b - 1, 200, 1_000_448, 64, sms)
    _check_plan(at, b, 200, 1_000_448, 64, sms)
    assert (below.route, at.route) == ("A", "B")


def test_route_b_needs_a_bag_per_warp_in_shared_memory():
    """A row too wide for 32 bags' sums in a block's shared memory keeps
    route A, however many bags."""
    d = (SWEEP_SMEM // SWEEP_WARPS // 16 + 1) * 4
    assert plan_route(10**6, 10, 1000, d, sms=H100_SMS).route == "A"
    assert plan_route(10**6, 10, 1000, d - 4, sms=H100_SMS).route == "B"


# ------------------------------- on the card --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 is CUDA C++ for sm_90a and has "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES + ["allpad", "outofrange"])
def test_kernel_matches_plain_on_the_card(cuda, name):
    idx, w, table = (x.to(cuda) for x in _args(name))
    reset_launch_counts()
    got = embedding.embedding_bag(table, idx, w, use_kernel=True)
    torch.cuda.synchronize()
    assert launch_counts()["embedding_bag"] == 1
    want = embedding_bag_plain(idx, w, table)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    pad = (idx < 0).all(1)
    assert bool((got[pad] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,v,d", [(512, 200, 5000, 64), (3, 0, 10, 8),
                                     (1000, 7, 64, 256), (65, 33, 900, 12)])
def test_kernel_shapes_on_the_card(cuda, b, l, v, d):
    gen = torch.Generator(device=cuda).manual_seed(b + l + d)
    idx = torch.randint(-1, v + 1, (b, l), generator=gen, device=cuda,
                        dtype=torch.int32)
    w = torch.rand((b, l), generator=gen, device=cuda)
    table = torch.randn((v, d), generator=gen, device=cuda)
    got = embedding_bag(idx, w, table)
    torch.testing.assert_close(got, embedding_bag_plain(idx, w, table),
                               rtol=TOL, atol=TOL)


def _draw(cuda, b, l, v, d, seed):
    """Bags over a table at the served model's scale (normal x 0.02, as
    ``embedding.table`` draws it): at L = 1,000 over normal(0, 1) rows,
    any two float32 summation orders differ by about 3e-5, above TOL."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    idx = torch.randint(-1, v + 1, (b, l), generator=gen, device=cuda,
                        dtype=torch.int32)
    w = torch.rand((b, l), generator=gen, device=cuda)
    table = torch.randn((v, d), generator=gen, device=cuda).mul_(0.02)
    return idx, w, table


def _route_of(b, l, v, d):
    return plan_route(b, l, v, d,
                      torch.cuda.get_device_properties(0).multi_processor_count)


def _held(idx, w, table):
    """The kernel against the plain version, one launch a call, identical
    bits from a second call; padding-only bags exactly 0."""
    reset_launch_counts()
    got = embedding_bag(idx, w, table)
    again = embedding_bag(idx, w, table)
    torch.cuda.synchronize()
    assert launch_counts()["embedding_bag"] == 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, embedding_bag_plain(idx, w, table),
                               rtol=TOL, atol=TOL)
    pad = (idx < 0).all(1)
    assert bool((got[pad] == 0).all())
    return got


# (L, V, D): L = 0, 1, 7 and 1,000; V from 10 rows to more than four
# windows of route B; D = 4, 8, 12, 64, 128 and 256
ROUTE_CASES = [(0, 10, 4), (1, 10, 8), (7, 1000, 12), (200, 700_000, 64),
               (1000, 20_000, 128), (33, 200_000, 256), (20, 10_000_000, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("l,v,d", ROUTE_CASES)
@pytest.mark.parametrize("side", ["A", "B"])
def test_kernel_routes_on_the_card(cuda, side, l, v, d):
    """Both routes on each side of the boundary (one bag per warp of route
    B's grid)."""
    edge = (torch.cuda.get_device_properties(0).multi_processor_count
            * SWEEP_WARPS)
    b = edge - 1 if side == "A" else edge
    plan = _route_of(b, l, v, d)
    assert plan.route == side
    if side == "B" and v * d * 4 > 4 * WINDOW_BYTES:
        assert plan.windows > 4
    _held(*_draw(cuda, b, l, v, d, seed=l + d))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 512, 262_144])
def test_kernel_serving_shapes_on_the_card(cuda, b):
    """B = 1 and bert4rec's serve_p99 (route A) and serve_bulk (route B,
    16 windows, 3 passes) bags over its table's shape."""
    idx, w, table = _draw(cuda, b, 200, 1_000_448, 64, seed=b)
    idx = torch.where(torch.rand(idx.shape, device=cuda) < 0.1, -1, idx)
    idx[0, :] = -1  # a bag of padding only
    idx[-1, 3] = table.shape[0]  # index V reads row V - 1
    _held(idx, w, table)


@pytest.mark.gpu
@pytest.mark.parametrize("side", ["A", "B"])
def test_kernel_repeated_indices_on_the_card(cuda, side):
    """Bags whose entries repeat a few rows, and bags of one row L times,
    in a table of several windows (all but one bag in the first)."""
    edge = (torch.cuda.get_device_properties(0).multi_processor_count
            * SWEEP_WARPS)
    b = edge - 1 if side == "A" else edge
    idx, w, table = _draw(cuda, b, 64, 300_000, 64, seed=7)
    idx = torch.where(idx >= 0, idx % 5, idx)
    idx[::3] = 2
    idx[1, :] = 299_999
    idx[2, :] = 300_000  # clipped to row V - 1
    w[1:3] = w[1:3].abs() + 0.01
    assert _route_of(*idx.shape, *table.shape).route == side
    got = _held(idx, w, table)
    torch.testing.assert_close(got[2], got[1] * w[2].sum() / w[1].sum(),
                               rtol=1e-4, atol=1e-4)
