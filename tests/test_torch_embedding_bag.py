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

The ``gpu`` tests hold the CUDA kernel to the plain version on the card
and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag,
    embedding_bag_padded,
    embedding_bag_plain,
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
