"""Chaos harness: deterministic fault injection for the AWPM pipeline.

The acceptance bar for the robustness layer: every injected fault is
provably either **detected** (the pipeline raises a typed error) or
**survived** (the served result is bit-identical to the reference
backend's, through a fallback). Zero silent corruptions.

Fault classes and their hooks:

  exchange payload faults   drop / duplicate / corrupt_index /
                            corrupt_weight / nan_weight applied to the
                            received buffers of either stage of
                            ``core.dist.a2a_bucketed_batched`` (the
                            ``dist._EXCHANGE_TAP`` hook, called as
                            ``tap(stage, outs, valid)``). Detection:
                            ``SolveOptions(exchange_check=True)``
                            conservation accounting (count + order-
                            independent checksum) -> ``ExchangeIntegrityError``.
                            Survival: ``resilient_solve`` degrades to the
                            local chain, which never touches the exchange.
  flip_converged            forces the batched AWAC convergence mask off
                            after ``count`` rounds (the
                            ``batch._CONVERGENCE_TAP`` hook in
                            ``batch.awac_loop``): the classic "looks
                            converged, is not" failure. Detection:
                            ``ResilientOptions(verify_convergence=True)``
                            audit (a converged result must admit no
                            augmenting 4-cycle). Survival: a single-instance
                            problem degrades to the local chain, whose
                            single-instance loop the tap cannot reach.
  backend failure           ``failing_backend`` / ``failing_grid`` patch the
                            engine entry points to raise (transiently or
                            persistently). Survival: retry + degradation.
  rank loss                 ``runtime.elastic.fail_hosts`` masking; survival
                            by the shrunk grid of ``surviving_grid`` or the
                            local chain.
  nan input                 non-finite weights in the problem itself.
                            Detection: ``core.preflight`` (the default
                            ``on_invalid="raise"``); survival:
                            ``on_invalid="sanitize"``.

All injection is seed-deterministic: positions are chosen by rank among
the valid entries, rotated by ``seed``. The taps are read when the engines
run, so ``inject`` only swaps a module-level hook and restores it on exit
(the port caches no compiled program that could keep a clean or faulty
exchange).

``run_chaos_matrix`` executes the whole detect-vs-survive matrix on a grid
of ``make_grid`` and returns one record per case, the same cases as the
JAX package's matrix, with these differences:

  - The local chain is the port's, ``cuda_persistent -> cuda -> torch ->
    reference``, and "auto" starts it on the problem's device: at the
    persistent kernel on the card, at "torch" on the CPU. The backend
    failure cases fail every rung above "reference" on that device
    ("cuda_persistent", "cuda" and "torch" on the card, "torch" on the
    CPU), where JAX's fail "xla" and "pallas".
  - The persistent kernel runs its loop inside the kernel, out of the
    convergence tap's reach (as JAX's "pallas_persistent" does). On the
    card the ``flip_converged`` detect case therefore asks for backend
    "cuda": every rung it reaches (the 1x1 grid with the sweep kernel,
    then "local cuda", "torch", "reference") runs the tapped
    ``batch.awac_loop``, and the sweep kernel runs in it. With "auto"
    the untapped persistent-kernel rung would serve it.
  - Rank loss on a grid of more than one row drops the last row's first
    rank; the ranks of the surviving rows serve the request on the shrunk
    grid, and each rank outside them serves it from its own local chain
    (``runtime.elastic``): both count as survival, bit-identical.
  - A 1x1 grid (the card) has no row to lose without losing the grid:
    ``device_loss_partial`` runs only when pr > 1, so its matrix has 28
    cases, the 2x4 grid's 29.

``main`` runs the matrix from the command line: ``--device cpu`` spawns
pr x pc gloo ranks, each of which runs it; on the card (the default) it
runs the 1x1 grid of one NCCL rank.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core import api as _api
from repro_torch.core.dist import ExchangeIntegrityError
from repro_torch.core.preflight import PreflightError
from repro_torch.runtime.resilient import (
    _LOCAL_CHAIN,
    ResilientOptions,
    TransientFault,
    VerificationError,
    resilient_solve,
    verify_result,
)

__all__ = [
    "EXCHANGE_FAULTS",
    "FaultSpec",
    "assert_all_ok",
    "failing_backend",
    "failing_grid",
    "inject",
    "run_chaos_matrix",
]

#: payload fault kinds the exchange tap implements
EXCHANGE_FAULTS = ("drop", "duplicate", "corrupt_index", "corrupt_weight",
                   "nan_weight")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault. ``stage`` selects which exchange stage the
    payload faults hit (1 = column routing, 2 = row routing, None = both);
    ``seed`` rotates which valid entries are chosen; ``count`` is how many
    entries per instance (payload faults) or how many AWAC rounds to allow
    before forcing convergence (flip_converged)."""

    kind: str
    stage: int | None = None
    seed: int = 0
    count: int = 1

    def __post_init__(self):
        if self.kind not in EXCHANGE_FAULTS + ("flip_converged",):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.stage not in (None, 1, 2):
            raise ValueError(f"stage must be None, 1, or 2, got {self.stage!r}")


def _selected(valid, seed: int, count: int):
    """[B, L] bool: deterministically pick ``min(count, n_valid)`` valid
    entries per instance, by rank among valid entries, rotated by seed."""
    idx = torch.cumsum(valid.to(torch.int32), dim=1) - 1
    nv = valid.sum(dim=1, keepdim=True)
    return valid & (((idx - seed) % nv.clamp(min=1)) < count)


def _exchange_tap(fault: FaultSpec):
    def tap(stage, outs, valid):
        if fault.stage is not None and stage != fault.stage:
            return outs, valid
        sel = _selected(valid, fault.seed, fault.count)
        if fault.kind == "drop":
            return outs, valid & ~sel
        if fault.kind == "duplicate":
            b, L = valid.shape
            bix = torch.arange(b, device=valid.device)
            src = sel.to(torch.int32).argmax(dim=1)  # the first selected
            dst = (~valid).to(torch.int32).argmax(dim=1)  # the first free
            do = sel.any(dim=1) & (~valid).any(dim=1)
            onehot = do[:, None] & (
                torch.arange(L, device=valid.device)[None, :] == dst[:, None])
            outs = [torch.where(onehot, a[bix, src][:, None], a)
                    for a in outs]
            return outs, valid | onehot
        if fault.kind == "corrupt_index":
            outs = [torch.where(sel, outs[0] + 1, outs[0])] + list(outs[1:])
            return outs, valid
        w = outs[-1]
        if fault.kind == "corrupt_weight":
            w = torch.where(sel, w * 1.0009765625 + 1.0, w)
        else:  # nan_weight
            w = torch.where(sel, torch.full_like(w, float("nan")), w)
        return list(outs[:-1]) + [w], valid

    return tap


def _convergence_tap(fault: FaultSpec):
    def tap(active, iters):
        # force "converged" once ``count`` rounds have run
        return active & (iters < fault.count)

    return tap


@contextlib.contextmanager
def inject(fault: FaultSpec):
    """Install ``fault``'s tap for the duration of the block."""
    from repro_torch.core import batch as _batch
    from repro_torch.core import dist as _dist

    if fault.kind == "flip_converged":
        prev = _batch._CONVERGENCE_TAP
        _batch._CONVERGENCE_TAP = _convergence_tap(fault)
    else:
        prev = _dist._EXCHANGE_TAP
        _dist._EXCHANGE_TAP = _exchange_tap(fault)
    try:
        yield
    finally:
        if fault.kind == "flip_converged":
            _batch._CONVERGENCE_TAP = prev
        else:
            _dist._EXCHANGE_TAP = prev


@contextlib.contextmanager
def failing_backend(*backends, exc_type=TransientFault,
                    fail_times: int | None = None):
    """Patch the local engine entry points so any solve resolving to one of
    ``backends`` raises ``exc_type``: persistently, or only for the first
    ``fail_times`` offending calls (a transient fault). Yields a dict whose
    ``n`` counts injected failures."""
    from repro_torch.core import batch as _batch
    from repro_torch.core import single as _single

    state = {"n": 0}

    def wrap(orig):
        def inner(row, *args, backend="auto", **kw):
            if _single.resolve_backend(backend, row.device) in backends:
                if fail_times is None or state["n"] < fail_times:
                    state["n"] += 1
                    raise exc_type(
                        f"injected {backends} backend failure "
                        f"#{state['n']}")
            return orig(row, *args, backend=backend, **kw)

        return inner

    orig_s, orig_b = _single._awpm, _batch._awpm_batched
    _single._awpm = wrap(orig_s)
    _batch._awpm_batched = wrap(orig_b)
    try:
        yield state
    finally:
        _single._awpm = orig_s
        _batch._awpm_batched = orig_b


@contextlib.contextmanager
def failing_grid(exc_type=TransientFault, fail_times: int | None = None):
    """Patch the distributed driver so grid dispatches raise ``exc_type``
    (persistently or for the first ``fail_times`` calls)."""
    from repro_torch.core import dist as _dist

    state = {"n": 0}
    orig = _dist._DistBatchedAWPM.run

    def run(self, *args, **kwargs):
        if fail_times is None or state["n"] < fail_times:
            state["n"] += 1
            raise exc_type(f"injected grid engine failure #{state['n']}")
        return orig(self, *args, **kwargs)

    _dist._DistBatchedAWPM.run = run
    try:
        yield state
    finally:
        _dist._DistBatchedAWPM.run = orig


# --------------------------------------------------------------------------
# the detect-vs-survive matrix
# --------------------------------------------------------------------------


def _bit_identical(result: _api.MatchResult, ref: _api.MatchResult) -> bool:
    return all(torch.equal(torch.as_tensor(getattr(result, k)).cpu(),
                           torch.as_tensor(getattr(ref, k)).cpu())
               for k in ("mate_row", "mate_col", "weight"))


def _pick_instance(n: int, avg_degree: float, min_awac_iters: int,
                   device=None):
    """Deterministic seed scan for an instance whose reference solve needs
    at least ``min_awac_iters`` AWAC rounds (so a prematurely-flipped
    convergence mask provably leaves an augmenting 4-cycle behind), built
    on ``device`` (None: the card). A fixed shared capacity keeps every
    candidate one shape."""
    from repro_torch.core import graph as _graph

    cap = None
    for seed in range(200):
        for kind in ("antigreedy", "uniform"):
            g = _graph.generate(n, avg_degree=avg_degree, kind=kind,
                                seed=seed)
            real = g.row < n
            if cap is None:
                cap = max(int(real.sum()) * 2, 64)
            if int(real.sum()) > cap:
                continue
            p = _api.MatchingProblem.from_coo(
                g.row[real], g.col[real], g.val[real], n, capacity=cap,
                device=device)
            r = _api.solve(p, _api.SolveOptions(backend="reference"))
            if bool(r.perfect) and int(r.awac_iters) >= min_awac_iters:
                return p, r
    raise RuntimeError(
        f"no planted instance with >= {min_awac_iters} AWAC rounds found")


def run_chaos_matrix(pr: int = 2, pc: int = 4, n: int = 48,
                     avg_degree: float = 6.0, log=print, device=None):
    """Execute the full fault-injection matrix on the pr x pc grid of
    ``make_grid`` (its default group must span pr * pc ranks; the 1x1
    grid starts its own). Every rank of the grid calls this with the same
    arguments. ``device=None`` means the card. Returns a list of records
    ``{"fault", "mode", "ok", "detail"}``, one per (fault class,
    detect/survive) case; every record must be ok."""
    import torch.distributed as tdist

    from repro_torch.core.dist import make_grid
    from repro_torch.runtime import elastic

    grid = make_grid(pr, pc, device=device)
    dev = grid.device
    gopts = _api.SolveOptions(grid=grid, exchange_check=True)
    records = []

    def record(fault, mode, ok, detail):
        records.append({"fault": fault, "mode": mode, "ok": bool(ok),
                        "detail": detail})
        log(f"[chaos] {'ok ' if ok else 'FAIL'} {fault:<24} {mode:<8} "
            f"{detail}")

    # a planted instance whose reference solve needs >= 3 AWAC rounds:
    # stopping after round 1 provably leaves an augmenting 4-cycle
    p, ref = _pick_instance(n, avg_degree, min_awac_iters=3, device=dev)

    # ---- exchange payload faults: detect via conservation accounting,
    # ---- survive via degradation to the local chain ----
    for kind in EXCHANGE_FAULTS:
        for stage in (1, 2):
            fault = FaultSpec(kind, stage=stage, seed=7)
            name = f"{kind}@stage{stage}"
            with inject(fault):
                try:
                    _api.solve(p, gopts)
                    record(name, "detect", False,
                           "no ExchangeIntegrityError raised")
                except ExchangeIntegrityError:
                    record(name, "detect", True, "ExchangeIntegrityError")
            with inject(fault):
                rr = resilient_solve(p, gopts)
                ok = _bit_identical(rr.result, ref) and rr.report.degraded
                record(name, "survive", ok, rr.report.summary())

    # ---- flip_converged: detected on a batched problem (every rung shares
    # ---- the tainted batched loop), survived by a single instance (the
    # ---- single-instance loop is out of the tap's reach). On the card the
    # ---- detect case asks for the sweep kernel (module docstring) ----
    fault = FaultSpec("flip_converged", count=1)
    pb = _api.MatchingProblem.stack([p, p], device=dev)
    ropts = ResilientOptions(verify_convergence=True)
    detect_backend = "cuda" if dev.type == "cuda" else "auto"
    with inject(fault):
        try:
            resilient_solve(pb, _api.SolveOptions(grid=grid,
                                                  backend=detect_backend),
                            resilience=ropts)
            record("flip_converged", "detect", False,
                   "premature convergence not flagged")
        except VerificationError as e:
            record("flip_converged", "detect", True,
                   f"VerificationError after {len(e.report.attempts)} "
                   f"attempt(s)")
    with inject(fault):
        rr = resilient_solve(p, _api.SolveOptions(grid=grid),
                             resilience=ropts)
        ok = _bit_identical(rr.result, ref) and rr.report.degraded
        record("flip_converged", "survive", ok, rr.report.summary())

    # ---- backend failures: transient (retry, same rung) and persistent
    # ---- (degrade down the chain), plus a dying grid engine. Every local
    # ---- rung above "reference" on this device fails ----
    from repro_torch.core.single import resolve_backend

    start = _LOCAL_CHAIN.index(resolve_backend("auto", dev))
    above = _LOCAL_CHAIN[start:_LOCAL_CHAIN.index("reference")]
    with failing_backend(*above, fail_times=1):
        rr = resilient_solve(p)
        record("backend_transient", "survive",
               _bit_identical(rr.result, ref) and not rr.report.degraded,
               rr.report.summary())
    with failing_backend(*above):
        rr = resilient_solve(p)
        ok = _bit_identical(rr.result, ref) \
            and rr.report.backend_used == "local reference"
        record("backend_persistent", "survive", ok, rr.report.summary())
    with failing_grid():
        rr = resilient_solve(p, _api.SolveOptions(grid=grid))
        ok = _bit_identical(rr.result, ref) and rr.report.degraded
        record("grid_engine_down", "survive", ok, rr.report.summary())

    # ---- rank loss: shrink to the surviving rows, or go local ----
    fleet = elastic.initial_fleet(grid)
    if pr > 1:
        dead = elastic.fail_hosts(fleet, [fleet.devices[-1, 0]])
        rr = resilient_solve(p, _api.SolveOptions(grid=grid), fleet=dead)
        used = rr.report.backend_used or ""
        inside = tdist.get_rank() in elastic.surviving_ranks(dead)
        ok = _bit_identical(rr.result, ref) and (
            "shrunk" in used if inside else used.startswith("local"))
        record("device_loss_partial", "survive", ok, rr.report.summary())
    dead_all = elastic.fail_hosts(fleet, fleet.devices[:, 0])
    rr = resilient_solve(p, _api.SolveOptions(grid=grid), fleet=dead_all)
    ok = _bit_identical(rr.result, ref) \
        and (rr.report.backend_used or "").startswith("local")
    record("device_loss_total", "survive", ok, rr.report.summary())

    # ---- nan input: rejected by preflight, or sanitized and re-verified.
    # The NaN edge goes into a padding slot, so sanitization restores
    # exactly ``p`` and the served result must be bit-identical to ref ----
    row, col, val = (x.clone() for x in (p.row, p.col, p.val))
    last = int(torch.nonzero(row >= n)[-1])
    row[last], col[last], val[last] = 0, 0, float("nan")
    p_nan = _api.MatchingProblem(row=row, col=col, val=val, n=n)
    try:
        _api.solve(p_nan, _api.SolveOptions(grid=grid))
        record("nan_input", "detect", False, "no PreflightError raised")
    except PreflightError:
        record("nan_input", "detect", True, "PreflightError")
    rr = resilient_solve(
        p_nan, _api.SolveOptions(grid=grid, exchange_check=True,
                                 on_invalid="sanitize"))
    ok = _bit_identical(rr.result, ref) \
        and not verify_result(p, rr.result)
    record("nan_input", "survive", ok, rr.report.summary())
    return records


def assert_all_ok(records):
    bad = [r for r in records if not r["ok"]]
    if bad:
        lines = "\n".join(
            f"  {r['fault']} [{r['mode']}]: {r['detail']}" for r in bad)
        raise AssertionError(
            f"{len(bad)} chaos case(s) neither detected nor survived:\n"
            f"{lines}")
    return records


def _rank_main(rank: int, pr: int, pc: int, n: int, workdir: str):
    """One spawned gloo rank of ``main --device cpu``: the matrix, its
    records written to ``workdir``."""
    import datetime
    import json
    import pathlib

    import torch.distributed as tdist

    torch.set_num_threads(1)
    work = pathlib.Path(workdir)
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(work / "store"), pr * pc),
        rank=rank, world_size=pr * pc,
        timeout=datetime.timedelta(seconds=60))
    log = print if rank == 0 else (lambda *a: None)
    records = run_chaos_matrix(pr, pc, n=n, log=log, device="cpu")
    (work / f"rank{rank}.json").write_text(json.dumps(records))
    tdist.barrier()
    tdist.destroy_process_group()


def main(argv=None):
    """CLI entry: run the full matrix on a pr x pc grid and exit non-zero
    on any silent corruption. ``--device cpu`` spawns pr * pc gloo ranks;
    the card (the default) runs the 1x1 grid on one NCCL rank."""
    import argparse
    import json
    import pathlib
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pr", type=int, default=None,
                    help="grid rows (default: 2 on the CPU, 1 on the card)")
    ap.add_argument("--pc", type=int, default=None,
                    help="grid columns (default: 4 on the CPU, 1 on the card)")
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks; default: the card")
    args = ap.parse_args(argv)
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    pr = args.pr if args.pr is not None else (2 if cpu else 1)
    pc = args.pc if args.pc is not None else (4 if cpu else 1)
    if not cpu:
        if (pr, pc) != (1, 1):
            raise SystemExit(
                f"a {pr}x{pc} grid needs {pr * pc} cards; the card runs the "
                f"1x1 grid (use --device cpu for gloo ranks)")
        records = assert_all_ok(run_chaos_matrix(1, 1, n=args.n,
                                                 device=args.device))
        print(f"ALL {len(records)} CASES OK on the 1x1 grid "
              f"({torch.cuda.get_device_name(0)})", flush=True)
        return
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="awpm-chaos-") as work:
        mp.start_processes(_rank_main, args=(pr, pc, args.n, work),
                           nprocs=pr * pc, join=True, start_method="spawn")
        per_rank = [json.loads((pathlib.Path(work) / f"rank{r}.json")
                               .read_text()) for r in range(pr * pc)]
    for records in per_rank:
        assert_all_ok(records)
    print(f"ALL {len(per_rank[0])} CASES OK on each of the {pr * pc} ranks "
          f"of the {pr}x{pc} grid", flush=True)


if __name__ == "__main__":
    main()
