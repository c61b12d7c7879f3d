"""The port's matching service (``repro_torch.serving``) against the JAX
package's, and the serving tier's host-side behaviour on its own.

The same open-loop stream (``run_stream`` on a simulated clock, n = 48)
drives both services, warm start on and off, and through the resilience
layer (``resilient=True``, whose ``Response.resilience`` summary must be
JAX's with JAX's local rung "xla" named "torch"): every ``Response`` must be
equal field by field, except the wall-clock fields (``solve_s``,
``completed_at``, ``latency_s``), with ``weight`` to rtol 1e-6 (a float32
sum whose order differs between torch and XLA); ``stats()`` must be equal
too. The JAX side runs once, in one child process.

The rest ports the JAX suite's serving cases (``tests/test_serving.py``):
size classes, routing, the plan cache, the deadline batcher, the warm
cache and its cold fallback, admission and the poisoned batchmate, each
service result held against the port's direct ``solve()``. Every service
here solves on the CPU (``device="cpu"``); the card's cases are marked
``gpu``.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    MatchingProblem,
    ProblemSpec,
    SolveOptions,
    graph,
    plan,
    solve,
)
from repro_torch.serving import (  # noqa: E402
    DeadlineBatcher,
    MatchingService,
    PlanCache,
    ServiceConfig,
    ShardRouter,
    SizeClass,
    StreamSpec,
    WarmStartCache,
    embed_instance,
    run_stream,
    size_class_for,
    solve_with_seed,
    strip_instance,
)
from test_torch_harness import (  # noqa: E402
    run_reference,
    same_dispatch_as_jax,
)


@pytest.fixture(scope="module", autouse=True)
def _same_dispatch_as_jax(tmp_path_factory):
    """"auto" resolves from the counterpart of JAX's committed dispatch
    table, so the chain starts where JAX's does (``same_dispatch_as_jax``)."""
    with same_dispatch_as_jax(tmp_path_factory.mktemp("dispatch")):
        yield


REPO = pathlib.Path(__file__).resolve().parents[1]

#: name -> (ServiceConfig kwargs, StreamSpec kwargs)
STREAMS = {
    "warm": ({}, dict(requests=64, users=8, rate_rps=400.0,
                      structure_churn=0.1, seed=0)),
    "cold": (dict(warm_start=False, num_shards=2, max_batch=4),
             dict(requests=40, users=5, rate_rps=900.0, seed=3)),
    "resilient": (dict(resilient=True, num_shards=2),
                  dict(requests=40, users=6, rate_rps=500.0,
                       structure_churn=0.2, seed=5)),
}
#: JAX's local rungs by the port's names ("auto" on the CPU: the plain
#: torch sweep where JAX runs its fused XLA one)
RUNGS = {"local xla": "local torch"}
INTS = ("request_id", "shard", "ok", "served_warm", "batch_fill", "class_n",
        "class_cap", "class_batch", "awac_iters", "perfect", "warm_started")

REFERENCE = """
import json
from repro.serving import MatchingService, ServiceConfig, StreamSpec, run_stream

def table(rs):
    ints, floats, strs, mr, mc = [], [], [], [], []
    for r in rs:
        res = r.result
        ints.append([r.request_id, r.shard, r.ok, r.served_warm,
                     r.batch_fill, r.size_class.n, r.size_class.cap,
                     r.size_class.batch, int(res.awac_iters),
                     bool(res.perfect), res.execution.warm_started])
        floats.append([r.submitted_at, r.dispatched_at, float(res.weight)])
        strs.append([r.key, r.lane, r.flush_reason, r.error or "",
                     r.resilience or ""])
        mr.append(np.asarray(res.mate_row))
        mc.append(np.asarray(res.mate_col))
    return (np.array(ints, np.int64), np.array(floats, np.float64),
            np.array(strs), np.stack(mr), np.stack(mc))

for name, (cfg, spec) in STREAMS.items():
    svc = MatchingService(ServiceConfig(**cfg))
    rs = run_stream(svc, StreamSpec(**spec))["responses"]
    for k, x in zip(("ints", "floats", "strs", "mr", "mc"), table(rs)):
        OUT[f"{name}__{k}"] = x
    OUT[f"{name}__stats"] = np.array(json.dumps(svc.stats(), sort_keys=True))
"""


def _table(responses):
    """The JAX child's ``table`` over the port's responses."""
    ints, floats, strs, mr, mc = [], [], [], [], []
    for r in responses:
        res = r.result
        ints.append([r.request_id, r.shard, r.ok, r.served_warm,
                     r.batch_fill, r.size_class.n, r.size_class.cap,
                     r.size_class.batch, int(res.awac_iters),
                     bool(res.perfect), res.execution.warm_started])
        floats.append([r.submitted_at, r.dispatched_at, float(res.weight)])
        strs.append([r.key, r.lane, r.flush_reason, r.error or "",
                     r.resilience or ""])
        mr.append(res.mate_row)
        mc.append(res.mate_col)
    return dict(ints=np.array(ints, np.int64),
                floats=np.array(floats, np.float64), strs=np.array(strs),
                mr=np.stack(mr), mc=np.stack(mc))


@pytest.fixture(scope="module")
def jax_streams(tmp_path_factory):
    header = f"STREAMS = {STREAMS!r}\n"
    return run_reference(header + REFERENCE, {},
                         tmp_path_factory.mktemp("serving"))


@pytest.mark.parametrize("name", list(STREAMS))
def test_service_matches_jax_on_a_stream(jax_streams, name):
    cfg, spec = STREAMS[name]
    svc = MatchingService(ServiceConfig(**cfg), device="cpu")
    summary = run_stream(svc, StreamSpec(**spec))
    got = _table(summary["responses"])
    assert len(summary["responses"]) == spec["requests"]
    want_strs = jax_streams[f"{name}__strs"].copy()
    for jax_rung, rung in RUNGS.items():
        want_strs = np.char.replace(want_strs, jax_rung, rung)
    np.testing.assert_array_equal(got["strs"], want_strs, err_msg="strs")
    for k in ("ints", "mr", "mc"):
        np.testing.assert_array_equal(got[k], jax_streams[f"{name}__{k}"],
                                      err_msg=k)
    want = jax_streams[f"{name}__floats"]
    np.testing.assert_array_equal(got["floats"][:, :2], want[:, :2])
    np.testing.assert_allclose(got["floats"][:, 2], want[:, 2], rtol=1e-6)
    assert json.dumps(svc.stats(), sort_keys=True) == \
        str(jax_streams[f"{name}__stats"])
    warm = got["ints"][:, INTS.index("served_warm")]
    if cfg.get("warm_start", True):
        assert warm.sum() > len(warm) // 2  # mostly warm
    else:
        assert warm.sum() == 0
    for r in summary["responses"]:
        assert r.solve_s > 0
        assert r.completed_at == r.dispatched_at + r.solve_s
        assert r.latency_s == r.completed_at - r.submitted_at
        assert isinstance(r.result.mate_row, np.ndarray)


# ------------------------------------------------------------------ helpers


def _identical(a, b):
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return (np.array_equal(host(a.mate_row), host(b.mate_row))
            and np.array_equal(host(a.mate_col), host(b.mate_col))
            and np.allclose(host(a.weight), host(b.weight)))


def _svc(**over):
    defaults = dict(num_shards=2, deadline_s=0.5, max_batch=4,
                    min_class_n=16, max_class_n=64)
    defaults.update(over)
    return MatchingService(ServiceConfig(**defaults), clock=lambda: 0.0,
                           device="cpu")


def _direct(g):
    return solve(MatchingProblem.from_graph(g, device="cpu"))


# ------------------------------------------------------------- size classes


def test_size_class_ladder():
    cls = size_class_for(5, 12)
    assert cls == SizeClass(n=32, cap=64, batch=8)  # 12 + 27 dummies -> 64
    cls = size_class_for(48, 200)
    assert cls == SizeClass(n=64, cap=256, batch=8)  # 200 + 16 -> 256
    # cap always covers a full identity diagonal even for sparse instances
    cls = size_class_for(33, 0)
    assert cls.n == 64 and cls.cap >= 64
    # same class for nearby sizes: that is the whole point of the ladder
    assert size_class_for(30, 90) == size_class_for(27, 80)


def test_size_class_oversize_is_exact_batch_1():
    cls = size_class_for(5000, 60000, max_class_n=4096)
    assert cls.n == 5000 and cls.batch == 1
    assert cls.cap == 60000 and cls.cap % 8 == 0
    cls = size_class_for(4097, 10, max_class_n=4096)
    assert cls.n == 4097 and cls.batch == 1 and cls.cap >= 4097


@pytest.mark.parametrize("bad", [
    lambda: size_class_for(0, 5),
    lambda: size_class_for(4, -1),
    lambda: SizeClass(n=32, cap=16, batch=1),  # cannot hold its own filler
], ids=["n0", "nnz_negative", "cap_below_n"])
def test_size_class_validation(bad):
    with pytest.raises(ValueError):
        bad()


def test_embed_and_strip_round_trip():
    g = graph.generate(13, avg_degree=4.0, seed=4)
    cls = size_class_for(13, g.nnz, min_class_n=16)
    emb = embed_instance(g, cls, device="cpu")
    assert (emb.n, emb.cap) == (16, cls.cap)
    r = solve(emb)
    stripped = strip_instance(r, None, 13, cls.n)
    assert stripped.mate_row.shape == (14,) and stripped.perfect
    assert _identical(stripped, _direct(g))
    with pytest.raises(ValueError, match="exceeds class n"):
        embed_instance(graph.generate(20, seed=1), cls, device="cpu")


# ------------------------------------------------------------------ routing


def test_shard_router_deterministic_and_consistent():
    r1, r2 = ShardRouter(4), ShardRouter(4)
    keys = [f"user-{i}" for i in range(200)]
    assert [r1.shard_for(k) for k in keys] == [r2.shard_for(k) for k in keys]
    for k in keys:
        assert r1.shard_for(k) == r1.slot_for(k) % 4
        assert 0 <= r1.slot_for(k) < r1.total_slots
    # growing the fleet remaps slots, not the hash space
    r8 = ShardRouter(8, n_bits=r1.n_bits)
    for k in keys:
        assert r8.slot_for(k) == r1.slot_for(k)
    # slots partition exactly across shards
    all_slots = sorted(s for sh in range(4) for s in r1.slots_for_shard(sh))
    assert all_slots == list(range(r1.total_slots))


@pytest.mark.parametrize("bad", [
    lambda: ShardRouter(0),
    lambda: ShardRouter(4, n_bits=0),
    lambda: ShardRouter(4).slots_for_shard(4),
], ids=["no_shards", "no_bits", "shard_out_of_range"])
def test_shard_router_validation(bad):
    with pytest.raises(ValueError):
        bad()


# --------------------------------------------------------------- plan cache


def test_plan_cache_lru_eviction_and_replan():
    built = []

    def builder(tag):
        def build():
            built.append(tag)
            return f"plan-{tag}"
        return build

    cache = PlanCache(capacity=2)
    assert cache.get("a", builder("a")) == "plan-a"
    assert cache.get("b", builder("b")) == "plan-b"
    assert cache.get("a", builder("a")) == "plan-a"  # hit: a now MRU
    assert cache.get("c", builder("c")) == "plan-c"  # evicts b (LRU)
    assert "b" not in cache and "a" in cache
    assert cache.stats.evictions == 1
    # an evicted key coming back is re-planned transparently
    assert cache.get("b", builder("b")) == "plan-b"
    assert built == ["a", "b", "c", "b"]
    assert cache.stats.hits == 1 and cache.stats.misses == 4


def test_plan_cache_throwing_build_leaves_cache_untouched():
    cache = PlanCache(capacity=1)
    cache.get("a", lambda: "plan-a")
    with pytest.raises(RuntimeError):
        cache.get("boom", lambda: (_ for _ in ()).throw(RuntimeError("x")))
    assert cache.keys() == ["a"]
    assert cache.get("a", lambda: "never") == "plan-a"


# ------------------------------------------------------------------ batcher


def test_batcher_deadline_flush_with_partial_batch():
    b = DeadlineBatcher(deadline_s=0.5)
    assert b.add("k", "r0", now=0.0, max_batch=4) is None
    assert b.due(now=0.4) == [] and b.pending() == 1
    assert b.next_deadline() == pytest.approx(0.5)
    flushes = b.due(now=0.7)  # pumped late, as a simulated clock does
    assert len(flushes) == 1
    f = flushes[0]
    assert f.items == ("r0",) and f.reason == "deadline"
    # latency is charged to the deadline, not to the late pump
    assert f.dispatched_at == pytest.approx(0.5)
    assert b.pending() == 0 and b.next_deadline() is None


def test_batcher_full_flush_is_immediate():
    b = DeadlineBatcher(deadline_s=10.0)
    assert b.add("k", "r0", now=0.0, max_batch=2) is None
    f = b.add("k", "r1", now=0.1, max_batch=2)
    assert f is not None and f.reason == "full"
    assert f.items == ("r0", "r1") and f.dispatched_at == pytest.approx(0.1)


def test_batcher_drain_and_validation():
    b = DeadlineBatcher(deadline_s=0.5)
    b.add("k1", "a", now=0.0, max_batch=4)
    b.add("k2", "b", now=0.2, max_batch=4)
    flushes = {f.key: f for f in b.drain(now=0.3)}
    assert set(flushes) == {"k1", "k2"}
    assert all(f.reason == "drain" for f in flushes.values())
    # drain before the deadline charges only the time actually waited
    assert flushes["k2"].dispatched_at == pytest.approx(0.3)
    with pytest.raises(ValueError):
        DeadlineBatcher(-1.0)
    with pytest.raises(ValueError):
        b.add("k", "x", now=0.0, max_batch=0)


# --------------------------------------------------------------- warm cache


def test_warm_cache_stale_class_and_lru():
    c = WarmStartCache(capacity=2)
    mr, mc = np.arange(17, dtype=np.int32), np.arange(17, dtype=np.int32)
    c.put("u1", 16, mr, mc)
    got = c.seed_for("u1", 16)
    assert got is not None and np.array_equal(got[0], mr)
    # a seed from another size class is stale, never repaired
    assert c.seed_for("u1", 32) is None
    assert c.seed_for("nobody", 16) is None
    assert (c.stats.served, c.stats.stale, c.stats.absent) == (1, 1, 1)
    c.put("u2", 16, mr, mc)
    c.put("u3", 16, mr, mc)  # evicts u1 (capacity 2)
    assert len(c) == 2 and c.seed_for("u1", 16) is None
    with pytest.raises(ValueError):
        c.put("bad", 16, np.arange(5), np.arange(5))


def test_warm_cache_takes_tensors_on_the_host():
    c = WarmStartCache()
    mr = torch.arange(17, dtype=torch.int64)
    c.put("u", 16, mr, mr)
    got = c.seed_for("u", 16)
    assert got[0].dtype == np.int32 and np.array_equal(got[0], mr.numpy())
    mr[0] = 5  # the cache keeps a copy
    assert c.seed_for("u", 16)[0][0] == 0


def test_solve_with_seed_falls_back_cold_bit_identically():
    g = graph.generate(12, avg_degree=4.0, kind="uniform", seed=3)
    p = MatchingProblem.from_graph(g, device="cpu")
    matcher = plan(ProblemSpec(n=p.n, cap=p.cap))
    cold = matcher(p)
    for bad in [(np.zeros(5, np.int32), np.zeros(5, np.int32)),  # stale shape
                12.5,                                            # not a seed
                (np.zeros(13, np.int32),)]:                      # not a pair
        result, served_warm = solve_with_seed(matcher, p, bad)
        assert not served_warm
        assert _identical(result, cold)
    # a valid fixed-point seed is served warm and returns bit-identically
    result, served_warm = solve_with_seed(matcher, p,
                                          (cold.mate_row, cold.mate_col))
    assert served_warm and _identical(result, cold)


# -------------------------------------------------------------- the service


def test_service_cold_lane_bit_identical_to_direct_solve():
    svc = _svc()
    gs = {f"user-{i}": graph.generate(13, avg_degree=4.0, seed=i)
          for i in range(3)}
    for key, g in gs.items():
        svc.submit(key, g, now=0.0)
    svc.drain(now=0.1)
    responses = svc.responses()
    assert len(responses) == 3
    for r in responses:
        assert r.ok and r.lane == "cold" and not r.served_warm
        direct = _direct(gs[r.key])
        assert _identical(r.result, direct)
        assert r.result.perfect == bool(direct.perfect)
        assert r.result.mate_row.shape == (14,)  # stripped back to true n


def test_service_deadline_flush_then_warm_repeat():
    svc = _svc(num_shards=1)
    g = graph.generate(12, avg_degree=4.0, seed=7)
    svc.submit("u", g, now=0.0)
    assert svc.responses() == []  # queued: batch not full, deadline not hit
    svc.pump(now=1.0)  # past the 0.5s deadline
    (first,) = svc.responses()
    assert first.flush_reason == "deadline" and first.lane == "cold"
    assert first.dispatched_at == pytest.approx(0.5)  # charged to deadline
    assert first.batch_fill == 1  # partial batch, padded by fillers
    # the same key again: seeded from its own converged mates -> warm lane,
    # and (same instance, fixed-point seed) bit-identical to the cold result
    svc.submit("u", g, now=2.0)
    svc.pump(now=3.0)
    (second,) = svc.responses()
    assert second.served_warm and second.lane == "warm"
    assert _identical(second.result, first.result)
    assert second.result.awac_iters == 1
    stats = svc.stats()
    assert stats["served_warm"] == 1 and stats["served_cold"] == 1
    assert stats["warm_cache"]["served"] == 1


def test_service_oversize_request_gets_own_class_and_dispatches_now():
    svc = _svc(max_class_n=16, max_batch=4)
    g = graph.generate(20, avg_degree=4.0, seed=5)  # n > max_class_n
    svc.submit("big", g, now=0.0)
    (r,) = svc.responses()  # batch=1 class: full on arrival, no deadline wait
    assert r.flush_reason == "full" and r.batch_fill == 1
    assert r.size_class.n == 20 and r.size_class.batch == 1
    assert _identical(r.result, _direct(g))


def test_service_poisoned_batchmate_degrades_alone():
    svc = _svc(num_shards=1)
    good = graph.generate(12, avg_degree=4.0, seed=11)
    # rows 0 and 1 both reach only column 0: structurally infeasible
    poisoned = MatchingProblem(
        row=torch.tensor([0, 1], dtype=torch.int32),
        col=torch.tensor([0, 0], dtype=torch.int32),
        val=torch.tensor([1.0, 2.0]), n=2)
    svc.submit("good", good, now=0.0)
    svc.submit("poisoned", poisoned, now=0.0)
    svc.drain(now=0.1)
    by_key = {r.key: r for r in svc.responses()}
    assert by_key["poisoned"].ok  # degraded, not failed
    assert not by_key["poisoned"].result.perfect
    assert by_key["poisoned"].result.diagnosis is not None
    assert by_key["good"].result.perfect
    assert _identical(by_key["good"].result, _direct(good))
    assert svc.stats()["degraded"] == 1


def test_service_admission_sanitize_and_reject():
    nan_problem = MatchingProblem(
        row=torch.tensor([0, 1], dtype=torch.int32),
        col=torch.tensor([1, 0], dtype=torch.int32),
        val=torch.tensor([float("nan"), 1.0]), n=2)
    svc = _svc()  # default: sanitize
    svc.submit("u", nan_problem, now=0.0)
    svc.drain(now=0.1)
    (r,) = svc.responses()
    assert r.ok and "sanitized at admission" in r.error
    svc = _svc(admission="reject")
    svc.submit("u", nan_problem, now=0.0)
    (r,) = svc.responses()  # rejected synchronously, nothing queued
    assert not r.ok and r.lane == "rejected" and r.result is None
    assert svc.stats()["rejected"] == 1
    with pytest.raises(ValueError):
        ServiceConfig(admission="explode")


def test_service_plan_cache_eviction_replans():
    # capacity 1 with two alternating classes: every class switch evicts
    # and re-plans; results must stay correct through it
    svc = _svc(plan_capacity=1, max_batch=1, max_class_n=64)
    small = graph.generate(10, avg_degree=3.0, seed=1)   # class n=16
    large = graph.generate(20, avg_degree=3.0, seed=2)   # class n=32
    for t, (key, g) in enumerate([("s", small), ("l", large),
                                  ("s2", small), ("l2", large)]):
        svc.submit(key, g, now=float(t))  # max_batch=1: dispatches now
    responses = {r.key: r for r in svc.responses()}
    assert len(responses) == 4
    assert svc.plans.stats.evictions >= 2 and len(svc.plans) == 1
    for key, g in [("s", small), ("s2", small), ("l", large), ("l2", large)]:
        assert _identical(responses[key].result, _direct(g))


def test_service_refusals():
    with pytest.raises(TypeError, match="SolveOptions"):
        MatchingService(ServiceConfig(options="fast"), device="cpu")
    svc = _svc()
    pb = MatchingProblem.stack([graph.generate(8, seed=0)] * 2,
                               device="cpu")
    with pytest.raises(ValueError, match="submit single instances"):
        svc.submit("u", pb, now=0.0)
    with pytest.raises(TypeError, match="BipartiteGraph or MatchingProblem"):
        svc.submit("u", np.eye(3), now=0.0)


def test_resilient_service_equals_the_plain_one():
    from repro_torch.runtime import chaos
    from repro_torch.runtime.resilient import ResilientOptions

    spec = StreamSpec(requests=32, users=4, structure_churn=0.2, seed=2)
    plain = _table(run_stream(MatchingService(device="cpu"), spec)
                   ["responses"])
    guard = ServiceConfig(resilient=True, resilience=ResilientOptions(
        verify_convergence=True))
    rs = run_stream(MatchingService(guard, device="cpu"), spec)["responses"]
    got = _table(rs)
    for k in ("ints", "mr", "mc", "floats"):
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    assert all(r.resilience == "served by local torch after 1 attempt(s)"
               for r in rs)
    with chaos.failing_backend("torch"):
        rs = run_stream(MatchingService(ServiceConfig(resilient=True),
                                        device="cpu"), spec)["responses"]
    np.testing.assert_array_equal(_table(rs)["mr"], plain["mr"])
    # the injection patches the cold engines (as JAX's does): a cold lane
    # degrades to the reference rung, a warm one is served as before
    for r in rs:
        want = "local reference (degraded)" if r.lane == "cold" \
            else "local torch after 1"
        assert want in r.resilience, (r.lane, r.resilience)
    assert {r.lane for r in rs} == {"cold", "warm"}


def test_service_builds_on_the_card_by_default():
    if torch.cuda.is_available():
        assert MatchingService().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MatchingService()


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.serving",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def test_cli_serves_a_stream_on_the_cpu():
    proc = _cli("--device", "cpu", "--requests", "32")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "32 requests" in out and "solves on cpu" in out
    assert "served        32 (" in out and "0 rejected" in out
    for line in ("throughput", "latency", "batch fill", "plan cache",
                 "warm cache"):
        assert line in out


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the service's solves run the AWAC "
                    "kernels (CUDA C++ for sm_90a, no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_service_on_the_card_equals_torch_backend(cuda):
    spec = StreamSpec(requests=48, users=6, structure_churn=0.2, seed=1)
    runs = {}
    for bk in ("torch", "auto", "cuda"):
        svc = MatchingService(ServiceConfig(options=SolveOptions(backend=bk)))
        runs[bk] = _table(run_stream(svc, spec)["responses"])
        assert runs[bk]["ints"][:, INTS.index("served_warm")].sum() > 0
    for bk in ("auto", "cuda"):
        for k in ("ints", "strs", "mr", "mc", "floats"):
            np.testing.assert_array_equal(runs[bk][k], runs["torch"][k],
                                          err_msg=f"{bk}: {k}")


@pytest.mark.gpu
def test_resilient_service_on_the_card_names_the_persistent_kernel(cuda):
    spec = StreamSpec(requests=48, users=6, structure_churn=0.2, seed=1)
    plain = _table(run_stream(MatchingService(), spec)["responses"])
    rs = run_stream(MatchingService(ServiceConfig(resilient=True)),
                    spec)["responses"]
    for k in ("ints", "mr", "mc", "floats"):
        np.testing.assert_array_equal(_table(rs)[k], plain[k], err_msg=k)
    assert all(r.resilience == "served by local cuda_persistent after 1 "
               "attempt(s)" for r in rs)
