"""K4, the AWPM router's swap-gain search, against the JAX package on the
CPU.

The JAX side runs once per module in a child process
(``test_torch_harness.run_reference``): ``router_swap_ref`` (the dense
oracle) and ``router_swap_padded`` (the Pallas kernel, interpreted, with
the tiles of ``tests/test_kernels.py``). The port's plain version
(``router_swap_plain``), its padded entry (``router_swap_padded``, which on
CPU tensors takes the plain version on padded inputs) and the batched
forms must give the same gains bit for bit and the same partners:

  - normal affinities at (T, E) = (128, 8), (300, 60) and (512, 64), and
    at T not a multiple of 64 with E not a multiple of 4, (100, 7) and
    (77, 13), which the CUDA kernel takes unpadded;
  - affinities rounded to bf16 (ties in the gains);
  - affinities at ``-1e6 + x`` on the experts a token already used (the
    router's second and later rounds, where float32 steps by 0.0625);
  - G = 3 groups of 120 tokens whose last 20 tokens have all-zero
    affinities (the padded tokens of a routing block);
  - every case again with ``assign`` as int64, as ``models/moe.py`` passes
    it.

The ``gpu`` tests hold the CUDA kernel to the plain version on the card,
bit for bit, at the router's prefill and decode shapes, at odd T and E,
with ties, all-masked columns and up to 8 groups, and skip here; on the
machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_router_swap.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.router_swap import (  # noqa: E402
    router_swap,
    router_swap_padded,
    router_swap_padded_batched,
    router_swap_plain,
    router_swap_plain_batched,
)
from test_torch_harness import run_reference  # noqa: E402

SHAPES = [(128, 8), (300, 60), (512, 64), (100, 7), (77, 13)]
KINDS = ("normal", "bf16", "penalized")
CASES = [f"{kind}_{t}x{e}" for kind in KINDS for t, e in SHAPES]
BATCH = dict(g=3, t=120, e=60, real=100)

REFERENCE = """
import jax.numpy as jnp
from repro.kernels.router_swap import router_swap_padded, router_swap_ref

for name in [k[:-4] for k in IN if k.endswith("_aff")]:
    aff = jnp.asarray(IN[name + "_aff"])
    assign = jnp.asarray(IN[name + "_assign"])
    cur = jnp.take_along_axis(aff, assign[:, None], axis=1)[:, 0]
    OUT[name + "_cur"] = cur
    OUT[name + "_ref_g"], OUT[name + "_ref_r"] = router_swap_ref(
        aff, assign, cur)
    # at T = 120 the JAX wrapper's own row tile (min(ti, T rounded up to
    # 8) = 120) does not divide its padded T (128) and it asserts: 8 does
    ti = 128 if aff.shape[0] >= 128 else 8
    OUT[name + "_pallas_g"], OUT[name + "_pallas_r"] = router_swap_padded(
        aff, assign, cur, ti=ti, tj=128)
"""


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _case(kind, t, e, seed):
    rng = np.random.default_rng(seed)
    aff = rng.normal(size=(t, e)).astype(np.float32)
    assign = rng.integers(0, e, t).astype(np.int32)
    if kind == "bf16":
        aff = _bf16(aff)
    elif kind == "penalized":
        used = rng.random((t, e)) < 0.3
        used[np.arange(t), assign] = rng.random(t) < 0.5
        aff = np.where(used, aff - 1e6, aff).astype(np.float32)
    return aff, assign


def _inputs():
    out = {}
    for i, (kind, (t, e)) in enumerate(
            (k, s) for k in KINDS for s in SHAPES):
        aff, assign = _case(kind, t, e, seed=t + e + i)
        out[f"{kind}_{t}x{e}_aff"] = aff
        out[f"{kind}_{t}x{e}_assign"] = assign
    rng = np.random.default_rng(5)
    g, t, e, real = (BATCH[k] for k in ("g", "t", "e", "real"))
    aff = _bf16(rng.normal(size=(g, t, e)).astype(np.float32))
    aff[:, real:] = 0.0
    # balanced, as the router's assignments are: each expert twice
    assign = np.stack([rng.permutation(np.repeat(np.arange(e), t // e))
                       for _ in range(g)]).astype(np.int32)
    for i in range(g):
        out[f"batch{i}_aff"] = aff[i]
        out[f"batch{i}_assign"] = assign[i]
    return out


INPUTS = _inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE, INPUTS, tmp_path_factory.mktemp("k4"))


def _port_inputs(ref, name):
    aff = torch.from_numpy(INPUTS[name + "_aff"])
    assign = torch.from_numpy(INPUTS[name + "_assign"])
    cur = torch.gather(aff, 1, assign.long()[:, None])[:, 0]
    np.testing.assert_array_equal(cur.numpy(), ref[name + "_cur"])
    return aff, assign, cur


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
    out = router_swap_plain(*_port_inputs(ref, name))
    _exact(out, ref, name, which)


@pytest.mark.parametrize("name", CASES)
def test_padded_matches_jax(ref, name):
    args = _port_inputs(ref, name)
    _exact(router_swap_padded(*args), ref, name, "pallas")
    _exact(router_swap_padded(*args, use_kernel=False), ref, name, "ref")


@pytest.mark.parametrize("name", CASES)
def test_int64_assign_matches_jax(ref, name):
    aff, assign, cur = _port_inputs(ref, name)
    _exact(router_swap_padded(aff, assign.long(), cur), ref, name, "pallas")
    gain, part = router_swap(aff[None], assign.long()[None], cur[None])
    _exact((gain[0], part[0]), ref, name, "ref")


def test_cases_have_ties_and_no_partner(ref):
    """The cases exercise the tie rule (some column's max is reached by two
    rows), and a group whose tokens all sit on one expert has no partner
    at all: gain -inf and partner -1 everywhere."""
    tied = 0
    for name in CASES:
        aff, assign, cur = _port_inputs(ref, name)
        a = aff[:, assign.long()]
        w = a + a.T - cur[:, None] - cur[None, :]
        w = w.masked_fill(assign[:, None] == assign[None, :], float("-inf"))
        g = w.amax(0)
        tied += int(((w == g) & (g > float("-inf"))).sum(0).gt(1).sum())
    assert tied > 0
    aff = torch.zeros(64, 8)
    gain, part = router_swap_plain(aff, torch.zeros(64, dtype=torch.int32),
                                   aff[:, 0])
    assert bool((gain == float("-inf")).all()) and bool((part == -1).all())


def test_batched_matches_each_group(ref):
    g = BATCH["g"]
    args = [_port_inputs(ref, f"batch{i}") for i in range(g)]
    aff, assign, cur = (torch.stack([a[j] for a in args]) for j in range(3))
    for use_kernel in (True, False):
        gain, part = router_swap_padded_batched(aff, assign, cur,
                                                use_kernel=use_kernel)
        for i in range(g):
            _exact((gain[i], part[i]), ref, f"batch{i}", "ref")
            _exact((gain[i], part[i]), ref, f"batch{i}", "pallas")
    # the batched plain form on the padded inputs, as the wrapper sees them
    gain, part = router_swap_plain_batched(aff, assign, cur)
    for i in range(g):
        _exact((gain[i], part[i]), ref, f"batch{i}", "ref")


def test_wrapper_refusals_and_cpu_route():
    aff = torch.zeros(2, 64, 8)
    assign = torch.zeros(2, 64, dtype=torch.int32)
    cur = torch.zeros(2, 64)
    reset_launch_counts()
    router_swap(aff, assign, cur)  # CPU tensors: the plain version
    # any T, any E up to 256 and an int64 assign go in unpadded
    router_swap(aff[:, :60, :6], assign[:, :60].long(), cur[:, :60])
    assert launch_counts()["router_swap"] == 0
    with pytest.raises(ValueError, match=r"in \[1, 256\]"):
        router_swap(torch.zeros(2, 64, 257), assign, cur)
    with pytest.raises(ValueError, match=r"in \[1, 256\]"):
        router_swap(aff[..., :0], assign, cur)
    with pytest.raises(ValueError, match="assign"):
        router_swap(aff, assign.short(), cur)
    with pytest.raises(ValueError, match="assign"):
        router_swap(aff, assign[:, :60], cur)
    with pytest.raises(ValueError, match="cur"):
        router_swap(aff, assign, cur.double())
    with pytest.raises(ValueError, match="affinity"):
        router_swap(aff[0], assign[0], cur[0])


# ------------------------------- on the card --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 is CUDA C++ for sm_90a and has "
                    "no CPU mode")
    return torch.device("cuda")


def _bits_equal(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


def _on_card(aff, assign, cuda):
    aff = torch.from_numpy(aff).to(cuda)
    assign = torch.from_numpy(assign).to(cuda)
    return aff, assign, torch.gather(aff, 2, assign.long()[..., None])[..., 0]


@pytest.mark.gpu
@pytest.mark.parametrize("idx", ["int32", "int64"])
@pytest.mark.parametrize("g,t,e", [(4, 2100, 60), (1, 60, 60), (1, 300, 60),
                                   (3, 120, 60), (2, 512, 64), (8, 100, 7),
                                   (5, 77, 13), (2, 1, 3), (1, 65, 256),
                                   (3, 200, 1), (8, 2100, 60)])
def test_kernel_matches_plain_on_the_card(cuda, g, t, e, idx):
    rng = np.random.default_rng(g + t + e)
    aff = _bf16(rng.normal(size=(g, t, e)).astype(np.float32))
    aff[:, t - t // 8:] = 0.0
    assign = rng.integers(0, e, (g, t)).astype(idx)
    aff, assign, cur = _on_card(aff, assign, cuda)
    reset_launch_counts()
    got = router_swap_padded_batched(aff, assign, cur)
    torch.cuda.synchronize()
    assert launch_counts()["router_swap"] == 1
    _bits_equal(got, router_swap_plain_batched(aff, assign, cur))
    _bits_equal(got, router_swap_padded_batched(aff, assign, cur,
                                                use_kernel=False))


@pytest.mark.gpu
@pytest.mark.parametrize("g,t,e", [(8, 333, 5), (3, 1000, 60)])
def test_kernel_ties_and_masked_columns_on_the_card(cuda, g, t, e):
    """Small-integer affinities tie on almost every column; group 0 has all
    its tokens on one expert (every column masked: gain -inf, partner -1)
    and group 1 all but one token."""
    rng = np.random.default_rng(t + e)
    aff = rng.integers(-2, 3, (g, t, e)).astype(np.float32)
    assign = rng.integers(0, e, (g, t)).astype(np.int64)
    assign[0] = 1
    assign[1] = 0
    assign[1, 0] = 1
    aff, assign, cur = _on_card(aff, assign, cuda)
    got = router_swap_padded_batched(aff, assign, cur)
    _bits_equal(got, router_swap_plain_batched(aff, assign, cur))
    gain, part = got
    assert bool((gain[0] == float("-inf")).all() and (part[0] == -1).all())
    assert bool((part[1, 1:] == 0).all())
    a = torch.gather(aff[2], 1, assign[2][None, :].expand(t, t))
    w = a + a.T - cur[2][:, None] - cur[2][None, :]
    w = w.masked_fill(assign[2][:, None] == assign[2][None, :], float("-inf"))
    assert int(((w == gain[2][None, :]) & (gain[2] > float("-inf"))).sum(0)
               .gt(1).sum()) > 0  # columns whose max two rows reach
