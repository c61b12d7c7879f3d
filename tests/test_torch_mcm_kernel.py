"""The MCM kernel (``kernels/csrc/mcm_persistent.cu``, every MCM phase of
one instance in one cooperative launch) against its plain version
(``core.single.mcm_plain``).

On the CPU:
  - ``single.mcm`` on a CPU tensor runs the plain version under every
    backend: counter ``mcm.kernel`` 0, ``mcm.phases`` and ``mcm.layers``
    counted, the same mates on every backend;
  - the wrapper checks its inputs and refuses a CPU tensor;
  - the kernel's scheme re-derived step for step in numpy (the free
    columns' bitmap kept by the flips, three frontier bitmaps used in turn,
    visit stamps, 64-bit claims reduced once a step, each survivor flipping
    its own path alone) gives the plain version's mates, phases, layers and
    free word, ties of -0.0 and +0.0 and -inf entries included, from the
    greedy matching and from none;
  - the kernel table (``backend.SOURCES``, ``HEADERS``, ``SIGNATURES``,
    ``RESTYPES``) agrees with the C entries the sources export and the
    headers they include, and every kernel has a launch counter.

On the card (marker ``gpu``, skipped here): the kernel against the plain
version, mates, phases and layers bit for bit, on every case of
``test_torch_single.py``'s suite, ties, -inf entries, padding, n = 1, a
matching greedy already made perfect, seeded powerlaw and uniform
instances at n = 2^18, a deficient instance under ``on_invalid="degrade"``,
and ``solve()``'s single route against the batched (B = 1) and warm routes.
On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mcm_kernel.py
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MatchingProblem,
    SolveOptions,
    batch,
    graph,
    single,
    solve,
)
from repro_torch.kernels import backend, launch_counts  # noqa: E402
from repro_torch.kernels.mcm.persistent import mcm_persistent  # noqa: E402
from repro_torch.sparse.csr import row_ptr_from_sorted  # noqa: E402
from test_torch_kernels import _coo  # noqa: E402
from test_torch_single import CASES  # noqa: E402

BACKENDS = ("auto", "reference", "torch", "cuda", "cuda_persistent")
CSRC = pathlib.Path(backend.__file__).resolve().parent / "csrc"


@pytest.fixture(autouse=True)
def tracer_off():
    obs.disable()
    obs.take()
    yield
    obs.disable()
    obs.take()


def _tied(n, seed, values):
    """Rows of about six entries whose values come from ``values``: many
    rows see several frontier edges of one value."""
    rng = np.random.default_rng(seed)
    m = 6 * n
    row = rng.integers(0, n, m)
    col = rng.integers(0, n, m)
    return _coo(n, row, col, rng.choice(np.asarray(values, np.float32), m),
                capacity=m + 13)


def _star(n):
    """Every row reaches column 0 (weight 2) and its own column (weight 1).
    From no matching every row's BFS parent is column 0, so all walkers
    claim one column and one survives."""
    row = np.concatenate([np.arange(n), np.arange(n)])
    col = np.concatenate([np.zeros(n, np.int64), np.arange(n)])
    val = np.concatenate([np.full(n, 2.0), np.full(n, 1.0)])
    return _coo(n, row, col, val)


#: name -> (graph, n) of the instances both routes are held to
def _instances():
    out = {f"suite_{k}": (g, g.n) for k, (g, *_) in CASES.items()}
    out["ties_halves"] = (_tied(400, 1, [0.25, 0.5, 0.75, 1.0]), 400)
    out["ties_signed_zero"] = (_tied(400, 2, [-0.0, 0.0]), 400)
    out["ties_zero_and_one"] = (_tied(400, 3, [-0.0, 0.0, 1.0]), 400)
    out["neg_inf"] = (_tied(400, 4, [-np.inf, 0.5, 1.0]), 400)
    out["all_neg_inf"] = (_tied(300, 5, [-np.inf]), 300)
    g = graph.generate(500, avg_degree=4.0, kind="powerlaw", seed=6)
    m = g.nnz
    out["padded"] = (graph.from_coo(g.row[:m], g.col[:m], g.val[:m], 500,
                                    capacity=m + 4000), 500)
    out["n1"] = (_coo(1, [0], [0], [0.5]), 1)
    out["n1_empty"] = (graph.from_coo(np.zeros(0, np.int64),
                                      np.zeros(0, np.int64),
                                      np.zeros(0, np.float32), 1,
                                      capacity=8), 1)
    out["star"] = (_star(64), 64)
    return out


INSTANCES = _instances()
LARGE = {f"{kind}_2e18": dict(n=2**18, avg_degree=5.0, kind=kind, seed=s)
         for s, kind in enumerate(("powerlaw", "uniform"))}


def _edges(g, device):
    return tuple(torch.as_tensor(x).to(device) for x in (g.row, g.col, g.val))


def _greedy(row, col, val, n):
    st = single.greedy_maximal(row, col, val, n)
    return st.mate_row, st.mate_col


# --------------------------------------------------------------------------
# The CPU: the plain route, the wrapper's checks, the kernel's scheme
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend_name", BACKENDS)
def test_mcm_on_the_cpu_is_plain_for_every_backend(backend_name):
    g, n = INSTANCES["suite_powerlaw"]
    row, col, val = _edges(g, "cpu")
    mr, mc = _greedy(row, col, val, n)
    want = single.mcm_plain(row, col, val, n, mr, mc)
    obs.enable()
    st = single.mcm(row, col, val, n, mr, mc, backend=backend_name)
    obs.disable()
    t = obs.take()
    assert torch.equal(st.mate_row, want[0])
    assert torch.equal(st.mate_col, want[1])
    assert t.count("mcm.kernel") == 0
    assert t.count("mcm.phases") == want[2] > 0
    assert t.count("mcm.layers") == want[3] > 0
    assert len(t.named("mcm.layer")) == want[3]
    assert not t.named("d2h.mcm")


def test_wrapper_refuses_a_cpu_tensor():
    """The kernel serves the card alone: ``single.mcm`` sends a CPU tensor
    to ``mcm_plain``, and the wrapper launches nothing for one."""
    g, n = INSTANCES["suite_uniform"]
    row, col, val = _edges(g, "cpu")
    mr, mc = _greedy(row, col, val, n)
    before = launch_counts()["mcm_persistent"]
    with pytest.raises(ValueError, match="CUDA"):
        mcm_persistent(row, col, val, row_ptr_from_sorted(row, n), mr, mc,
                       n=n)
    assert launch_counts()["mcm_persistent"] == before


def test_wrapper_checks_its_inputs():
    g, n = INSTANCES["suite_uniform"]
    row, col, val = _edges(g, "cpu")
    mr, mc = _greedy(row, col, val, n)
    rp = row_ptr_from_sorted(row, n)
    bad = [
        (row, col, val, rp[:-1], mr, mc),  # row_ptr [n + 1]
        (row, col, val.double(), rp, mr, mc),  # float64 values
        (row, col, val, rp, mr[:n], mc),  # no sentinel slot
        (row[None], col[None], val[None], rp, mr, mc),  # a batch
    ]
    for args in bad:
        with pytest.raises(ValueError):
            mcm_persistent(*args, n=n)


def test_plain_counts_match_its_stats():
    """``mcm_plain``'s phases and layers are the tracer's counters, and a
    perfect matching runs no phase (no column free)."""
    g, n = INSTANCES["suite_antigreedy"]
    row, col, val = _edges(g, "cpu")
    mr, mc = _greedy(row, col, val, n)
    obs.enable()
    out = single.mcm_plain(row, col, val, n, mr, mc)
    obs.disable()
    t = obs.take()
    assert (t.count("mcm.phases"), t.count("mcm.layers")) == out[2:4]
    again = single.mcm_plain(row, col, val, n, out[0], out[1])
    assert again[2:] == (0, 0, False)


def kernel_scheme(col, val, row_ptr, mate_row, mate_col, n):
    """``mcm_persistent.cu``'s scheme, sequentially in numpy: a bitmap of
    the free columns built once and kept by each flip, with their count;
    three frontier bitmaps used in turn by the layer's number over the
    launch (read one, set the next, clear the third); visit stamps never
    cleared; claims as 64-bit keys (~phase, walker) reduced once a step
    (the atomicMin) and never cleared, each walker claiming its next
    column as it moves; each survivor of the last step flipping its own
    path alone. Returns (mate_row, mate_col, phases, layers, free)."""
    mr, mc = mate_row.copy(), mate_col.copy()
    claim = [2**64 - 1] * n
    visit, parent, wcur = (np.zeros(n, np.int64) for _ in range(3))
    walk = np.zeros(n, bool)
    free_bits = mr[:n] == n
    free_count = int(free_bits.sum())
    front = np.zeros((3, n), bool)

    def key(phase, w):
        return ((0xFFFFFFFF - phase) << 32) | int(w)

    phases = layers = g = phase = 0
    while phase <= n and free_count > 0:
        phase += 1
        phases += 1
        k, found = 0, False
        while True:
            g += 1
            cur_front = free_bits if k == 0 else front[g % 3]
            nxt = front[(g + 1) % 3]
            front[(g + 2) % 3] = False
            f_found = f_visited = False
            for i in range(n):
                if visit[i] == phase:
                    continue
                best, bc = -np.inf, -1
                for e in range(row_ptr[i], row_ptr[i + 1]):
                    if cur_front[col[e]] and val[e] > best:
                        best, bc = val[e], col[e]
                if bc < 0:
                    continue
                visit[i], parent[i], f_visited = phase, bc, True
                if mc[i] == n:
                    f_found, walk[i] = True, True
                    claim[bc] = min(claim[bc], key(phase, i))
                else:
                    nxt[mc[i]] = True
            layers += 1
            found = f_found
            if found or not f_visited or k + 1 > n:
                break
            k += 1
        if not found:
            break
        steps = k + 1
        for t in range(steps):
            claims, flips = [], []
            for i in np.nonzero(walk)[0]:
                cur = i if t == 0 else wcur[i]
                j = parent[cur]
                if claim[j] != key(phase, i):
                    walk[i] = False
                elif t + 1 == steps:
                    flips.append(i)
                    walk[i] = False
                else:
                    cur = mr[j] if mr[j] < n else cur
                    wcur[i] = cur
                    claims.append((parent[cur], key(phase, i)))
            for j, kk in claims:
                claim[j] = min(claim[j], kk)
            for cur in flips:
                for _ in range(steps):
                    j = parent[cur]
                    prev = mr[j]
                    mr[j], mc[cur] = cur, j
                    if prev >= n:
                        free_bits[j] = False
                        free_count -= 1
                        break
                    cur = prev
    return mr, mc, phases, layers, free_count > 0


#: (instance, start): from the greedy matching and from none, as the card
#: tests run the kernel
SCHEME = [(name, start) for name in INSTANCES for start in ("greedy",
                                                            "empty")]


@pytest.mark.parametrize("name,start", SCHEME,
                         ids=[f"{a}-{b}" for a, b in SCHEME])
def test_kernel_scheme_matches_plain(name, start):
    g, n = INSTANCES[name]
    row, col, val = _edges(g, "cpu")
    if start == "empty":
        mr = mc = torch.full((n + 1,), n, dtype=torch.int32)
    else:
        mr, mc = _greedy(row, col, val, n)
    want = single.mcm_plain(row, col, val, n, mr, mc)
    got = kernel_scheme(col.numpy(), val.numpy(),
                        row_ptr_from_sorted(row, n).numpy(), mr.numpy(),
                        mc.numpy(), n)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert got[2:] == (want[2], want[3], want[4])


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", ["suite_powerlaw", "suite_antigreedy",
                                  "ties_halves", "neg_inf",
                                  "suite_infeasible"])
def test_no_column_is_claimed_in_two_steps(monkeypatch, device, name):
    """What lets the kernel keep one claim per column for a whole phase:
    in the plain trace a column is claimed at one step of a phase at most
    (it sits in one BFS layer), on the device the plain route runs on."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, n = INSTANCES[name]
    row, col, val = _edges(g, device)
    mr, mc = _greedy(row, col, val, n)
    phases, real_trace, real_min = [], single.trace_and_flip, \
        single.segment_min

    def trace(*args, **kwargs):
        phases.append([])
        return real_trace(*args, **kwargs)

    def claims(values, segment_ids, num_segments, live=None):
        phases[-1].append(set(segment_ids[live].tolist()))
        return real_min(values, segment_ids, num_segments, live=live)

    monkeypatch.setattr(single, "trace_and_flip", trace)
    monkeypatch.setattr(single, "segment_min", claims)
    single.mcm(row, col, val, n, mr, mc, backend="torch")
    assert sum(len(steps) for steps in phases) > 0
    for steps in phases:
        seen = set()
        for cols in steps:
            assert not cols & seen
            seen |= cols


def _exports(text: str) -> dict[str, int]:
    """name -> number of parameters of each ``extern "C"`` function."""
    out = {}
    for m in re.finditer(r'extern "C"\s+[\w ]+?\s+(\w+)\s*\(([^)]*)\)',
                         text):
        params = [p for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = len(params)
    return out


def test_kernel_table_matches_the_sources():
    exported = {}
    for name in backend.SOURCES:
        exported.update(_exports((CSRC / name).read_text()))
    assert set(exported) == set(backend.SIGNATURES)
    for name, argtypes in backend.SIGNATURES.items():
        assert len(argtypes) == exported[name], name
    assert set(backend.RESTYPES) <= set(backend.SIGNATURES)
    assert {p.name for p in CSRC.glob("*.cu")} == set(backend.SOURCES)
    assert {p.name for p in CSRC.glob("*.cuh")} == set(backend.HEADERS)
    included = set()
    for p in CSRC.iterdir():
        included |= set(re.findall(r'#include "([^"]+)"', p.read_text()))
    assert included == set(backend.HEADERS)


def test_mcm_kernel_has_its_entries_and_counter():
    assert backend.SIGNATURES["mcm_persistent_scratch_bytes"] == [
        backend.c_int]
    assert backend.RESTYPES["mcm_persistent_scratch_bytes"] is backend.c_ll
    assert "mcm_persistent.cu" in backend.SOURCES
    assert launch_counts()["mcm_persistent"] >= 0
    backend.reset_launch_counts()
    assert set(launch_counts().values()) == {0}


# --------------------------------------------------------------------------
# The card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MCM kernel is CUDA C++ for "
                    "sm_90a and has no CPU mode")
    return torch.device("cuda")


def _both(row, col, val, n, mr, mc):
    """(kernel, plain) outputs on the card: the kernel's (mate_row,
    mate_col, stats) and ``mcm_plain``'s (mate_row, mate_col, phases,
    layers, free)."""
    rp = row_ptr_from_sorted(row, n)
    before = launch_counts()["mcm_persistent"]
    got = mcm_persistent(row, col, val, rp, mr, mc, n=n)
    assert launch_counts()["mcm_persistent"] == before + 1
    want = single.mcm_plain(row, col, val, n, mr, mc)
    return got, want


def _assert_same(got, want, what):
    for k, label in enumerate(("mate_row", "mate_col")):
        assert got[k].dtype == want[k].dtype, (what, label)
        assert torch.equal(got[k], want[k]), (what, label)
    assert got[2].dtype == torch.int64, (what, "stats")
    assert got[2].tolist() == [want[2], want[3], int(want[4])], (what,
                                                                 "stats")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(INSTANCES))
def test_kernel_matches_plain(cuda, name):
    g, n = INSTANCES[name]
    row, col, val = _edges(g, cuda)
    mr, mc = _greedy(row, col, val, n)
    _assert_same(*_both(row, col, val, n, mr, mc), name)
    empty = torch.full((n + 1,), n, dtype=torch.int32, device=cuda)
    _assert_same(*_both(row, col, val, n, empty, empty), name + " (empty)")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(LARGE))
def test_kernel_matches_plain_at_scale(cuda, name):
    g = graph.generate(**LARGE[name])
    n = g.n
    row, col, val = _edges(g, cuda)
    mr, mc = _greedy(row, col, val, n)
    got, want = _both(row, col, val, n, mr, mc)
    _assert_same(got, want, name)
    phases, layers, _ = got[2].tolist()
    assert phases >= 3 and layers >= phases  # many phases, not one


@pytest.mark.gpu
def test_perfect_greedy_runs_no_phase(cuda):
    n = 256
    g = _coo(n, np.arange(n), np.arange(n), np.full(n, 0.5))
    row, col, val = _edges(g, cuda)
    mr, mc = _greedy(row, col, val, n)
    assert bool((mr[:n] < n).all())
    got, want = _both(row, col, val, n, mr, mc)
    _assert_same(got, want, "perfect")
    assert got[2].tolist() == [0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("backend_name", BACKENDS)
def test_single_mcm_picks_the_path_on_the_card(cuda, backend_name):
    g, n = INSTANCES["suite_powerlaw"]
    row, col, val = _edges(g, cuda)
    mr, mc = _greedy(row, col, val, n)
    plain = single.mcm(row, col, val, n, mr, mc, backend="torch")
    obs.enable()
    st = single.mcm(row, col, val, n, mr, mc, backend=backend_name)
    obs.disable()
    t = obs.take()
    kernel = single.resolve_backend(backend_name, cuda, n=n) in \
        single.KERNEL_BACKENDS
    assert t.count("mcm.kernel") == int(kernel)
    assert len(t.named("d2h.mcm")) == int(kernel)
    assert bool(t.named("mcm.layer")) != kernel
    for field in ("mate_row", "mate_col", "u", "v"):
        assert torch.equal(getattr(st, field), getattr(plain, field)), field


@pytest.mark.gpu
def test_deficient_instance_under_degrade(cuda):
    g, _ = INSTANCES["suite_infeasible"]  # rows 0 and 1 reach column 0 alone
    p = MatchingProblem.from_graph(g, device=cuda)
    opts = dict(on_invalid="degrade")
    kern = solve(p, SolveOptions(**opts))
    plain = solve(p, SolveOptions(backend="torch", **opts))
    assert not bool(kern.perfect)
    assert kern.diagnosis is not None
    for r in (kern, plain):
        assert torch.equal(r.mate_row, plain.mate_row)
        assert torch.equal(r.mate_col, plain.mate_col)
    assert kern.diagnosis.summary() == plain.diagnosis.summary()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["powerlaw", "uniform", "antigreedy"])
def test_single_route_matches_batched_and_warm(cuda, kind):
    g = graph.generate(20000, avg_degree=5.0, kind=kind, seed=4)
    p = MatchingProblem.from_graph(g, device=cuda)
    backend.reset_launch_counts()
    one = solve(p)
    assert launch_counts()["mcm_persistent"] == 1
    b1 = solve(MatchingProblem.stack([g], device=cuda))
    assert launch_counts()["mcm_persistent"] == 1  # the batched engine's own
    warm = solve(p, warm_start=one)
    plain = solve(p, SolveOptions(backend="torch"))
    for r in (plain, warm):
        assert torch.equal(r.mate_row, one.mate_row)
        assert torch.equal(r.mate_col, one.mate_col)
    assert torch.equal(b1.mate_row[0], one.mate_row)
    assert torch.equal(b1.mate_col[0], one.mate_col)
    assert int(b1.awac_iters[0]) == int(one.awac_iters) \
        == int(plain.awac_iters)
    # greedy + MCM as the batched engine runs them, per instance
    row, col, val = _edges(g, cuda)
    mr, mc = _greedy(row, col, val, g.n)
    bmr, bmc = batch.mcm_batched(row[None], col[None], val[None], g.n,
                                 mr[None], mc[None])
    st = single.mcm(row, col, val, g.n, mr, mc)
    assert torch.equal(bmr[0], st.mate_row) and torch.equal(bmc[0],
                                                            st.mate_col)
