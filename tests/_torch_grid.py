"""Spawned gloo ranks for the torch port's grid tests, on the CPU.

``run_grid`` starts one process per rank of a Pr x Pc grid
(``torch.multiprocessing``, spawn), which meet on a ``FileStore`` in the
test's own directory (no TCP port, so parallel test workers cannot
collide), build the grid with ``make_grid(pr, pc, device="cpu")`` and run
the same list of jobs. Each job is the name of a function below and its
keyword arguments (numpy arrays and plain values); its result, or the
error it raised, is pickled per rank. The whole run has a join timeout of
its own, so a rank that deadlocks fails the test instead of the suite.
"""
from __future__ import annotations

import datetime
import pathlib
import pickle
import time

import numpy as np

#: the whole spawn's deadline; a collective gives up after a minute
JOIN_TIMEOUT_S = 240


def run_grid(pr: int, pc: int, jobs, workdir,
             timeout: float = JOIN_TIMEOUT_S) -> list[dict]:
    """Run ``jobs`` ([(name, function name, kwargs)]) on every rank of a
    pr x pc grid of spawned gloo ranks. Returns one dict per rank: name ->
    the job's result, or ("raised", error type, message)."""
    import torch.multiprocessing as mp

    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "jobs.pkl").write_bytes(pickle.dumps(jobs))
    ctx = mp.start_processes(_rank_main, args=(pr, pc, str(workdir)),
                             nprocs=pr * pc, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{pr}x{pc} grid: the ranks did not finish within "
                    f"{timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes())
            for r in range(pr * pc)]


def _rank_main(rank: int, pr: int, pc: int, workdir: str):
    import torch
    import torch.distributed as dist

    from repro_torch.core import make_grid

    torch.set_num_threads(1)
    work = pathlib.Path(workdir)
    store = dist.FileStore(str(work / "store"), pr * pc)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=pr * pc,
                            timeout=datetime.timedelta(seconds=60))
    grid = make_grid(pr, pc, device="cpu")
    out = {}
    for name, fn, kwargs in pickle.loads((work / "jobs.pkl").read_bytes()):
        try:
            out[name] = JOBS[fn](grid, **kwargs)
        except Exception as e:  # the test reads the error
            out[name] = ("raised", type(e).__name__, str(e))
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def _np(x):
    return x.cpu().numpy()


def job_driver(grid, row, col, val, n, backend="fused", packed=False,
               state=None):
    """``dist._DistBatchedAWPM(...).run``: mates, duals, iterations and
    dropped."""
    import torch

    from repro_torch.core import dist as D
    from repro_torch.core.single import MatchState

    if state is not None:
        state = MatchState(*(torch.from_numpy(x) for x in state))
    drv = D._DistBatchedAWPM(grid, n, backend=backend, packed=packed)
    st, iters, dropped = drv.run(row, col, val, state=state)
    return dict(mate_row=_np(st.mate_row), mate_col=_np(st.mate_col),
                u=_np(st.u), v=_np(st.v), iters=_np(iters),
                dropped=int(dropped))


def job_solve(grid, row, col, val, n, tap=None, warm=None, **options):
    """``solve()`` on the grid: the result's array fields. ``tap`` names
    a corruption of the exchange, set for this call only; ``warm``, a
    (mate_row, mate_col) pair, seeds the solve."""
    from repro_torch.core import MatchingProblem, SolveOptions, solve
    from repro_torch.core import dist as D
    from repro_torch.core.convert import problem_from_numpy, result_to_numpy

    p = problem_from_numpy(row, col, val, n, device="cpu")
    assert isinstance(p, MatchingProblem)
    prev = D._EXCHANGE_TAP
    D._EXCHANGE_TAP = None if tap is None else _TAPS[tap]
    try:
        r = solve(p, SolveOptions(grid=grid, **options), warm_start=warm)
    finally:
        D._EXCHANGE_TAP = prev
    out = result_to_numpy(r)
    out["execution"] = (r.execution.backend, r.execution.source)
    out["warm_started"] = r.execution.warm_started
    return out


def job_moe(grid, logits, k, cap):
    """``models.moe.matching_route_batched`` through the grid."""
    import torch

    from repro_torch.models import moe as M

    out = M.matching_route_batched(torch.from_numpy(logits), k, cap,
                                   dist_spec=grid)
    return [_np(x) for x in out[:3]]


def job_chaos(grid, n=48):
    """``runtime.chaos.run_chaos_matrix`` on the grid: its records."""
    from repro_torch.runtime import chaos

    return chaos.run_chaos_matrix(grid.pr, grid.pc, n=n, device="cpu",
                                  log=lambda *a: None)


def job_int8_psum(grid, grads, steps, axis):
    """``training.grad_compression.compress_int8_psum`` over this rank's
    group (``axis`` "rows": its grid column's group, which holds every
    grid row; "row": its grid row's group) for ``steps`` error-feedback
    steps of this rank's gradients (``grads``: {leaf: [ranks, steps,
    ...]}). Per step and leaf: the exchange's parts (payload, scale,
    sum, shared scale, mean, residual) from ``int8_allreduce``, which
    the tree function's outputs must equal."""
    import torch

    from repro_torch.training import grad_compression as gc

    group = {"rows": grid.col_group, "row": grid.row_group}[axis]
    state = gc.init_state({k: torch.from_numpy(v[grid.rank, 0])
                           for k, v in grads.items()})
    out = []
    for s in range(steps):
        g = {k: torch.from_numpy(v[grid.rank, s]) for k, v in grads.items()}
        parts = {k: gc.int8_allreduce(g[k], state.residual[k], group)
                 for k in sorted(g)}
        mean, state = gc.compress_int8_psum(g, state, group)
        for k, e in parts.items():
            assert torch.equal(mean[k], e.mean), k
            assert torch.equal(state.residual[k], e.residual), k
        out.append({k: {f: _np(getattr(e, f)) for f in e._fields}
                    for k, e in parts.items()})
    return out


def job_reshard(grid, dead, leaves, specs, ckdir, step=3):
    """Save a state with ``checkpoint.CheckpointManager`` (rank 0, into
    ``ckdir``), restore it whole on every rank, fail the ranks
    ``dead`` and cut the restored state by ``runtime.elastic.
    reshard_state`` onto the surviving grid. Returns None outside the
    grid, else (the grid's shape and this rank's position, its blocks)."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import elastic

    like = {"params": {k: torch.zeros(v.shape, dtype=torch.float32)
                       for k, v in leaves.items()}}
    if grid.rank == 0:
        CheckpointManager(ckdir).save(step, {k: torch.from_numpy(v)
                                             for k, v in leaves.items()})
    dist.barrier()
    params, _, at = CheckpointManager(ckdir).restore_latest(like=like)
    assert at == step
    fleet = elastic.fail_hosts(elastic.initial_fleet(grid), dead)
    new = elastic.surviving_grid(fleet, device="cpu")
    blocks = elastic.reshard_state(params, {k: tuple(v) for k, v in
                                            specs.items()}, new)
    if new is None:
        return None
    return ((new.pr, new.pc, new.a, new.b),
            {k: _np(v) for k, v in blocks.items()})


def _corrupt_weight(stage, outs, valid):
    """Nudge the first valid weight of the stage-2 exchange."""
    if stage != 2:
        return outs, valid
    w = outs[-1].clone()
    hit = valid & (valid.cumsum(dim=1) == 1)
    w[hit] = w[hit] + 1.0
    return [*outs[:-1], w], valid


def _drop_one(stage, outs, valid):
    """Lose the first valid entry of the stage-1 exchange."""
    if stage != 1:
        return outs, valid
    return outs, valid & ~(valid.cumsum(dim=1) == 1)


_TAPS = {"corrupt_weight": _corrupt_weight, "drop_one": _drop_one}

JOBS = {"driver": job_driver, "solve": job_solve, "moe": job_moe,
        "chaos": job_chaos, "int8_psum": job_int8_psum,
        "reshard": job_reshard}


def same(a, b) -> bool:
    """Deep equality of two job results (arrays bit for bit)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b
