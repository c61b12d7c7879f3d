"""Per-matrix AWPM quality evaluation in the paper's metric (the port of
the JAX package's ``experiments/paper_eval.py``).

The paper's claim is about real matrices: AWPM weights "very close to the
optimum" on SuiteSparse instances under MC64 log-scaled weights. This
module is that experiment's harness:

  - cases: the Matrix Market fixtures in ``tests/data/`` (loaded through
    ``data.mtx`` with a weight transform per fixture) and instances of the
    synthetic ``core.graph.matrix_suite``;
  - sweep: every case through the ``solve()``/``Matcher`` facade with the
    local backends ("reference", "torch", "cuda", "cuda_persistent"),
    ``"auto"`` (which records how it was resolved) and the process grids:
    the 1x1 grid in this process through ``plan()`` on
    ``core.dist.make_grid(1, 1, device)``, larger grids as spawned gloo
    ranks on the CPU, each building the same cases and running the same
    ``Matcher`` calls;
  - evidence per (case, engine): the matching weight, the AWAC rounds, the
    wall time of a later call (ending in a device sync), the LP-dual
    certified ratio bound (``core.dual``), the exact ratio where the
    ``ref.exact_mwpm`` oracle is tractable, and bit-identity to the
    "reference" backend.

``run_eval`` raises on an unsound certificate (bound < exact optimum), on
a backend that disagrees with "reference" and on an imperfect matching.
It runs on the card (``device=None``) and raises without one unless it is
given ``device="cpu"``. Outputs: a markdown table and a JSON record under
``results/torch/`` (the JAX runner's ``results/paper_eval.md`` and
``BENCH_paper_eval.json`` are its own). The cases are files on disk;
``data.suitesparse.fetch`` puts the paper's SuiteSparse instances there
on request, and nothing here downloads.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pathlib
import platform
import subprocess
import tempfile
import time
from typing import Sequence

import numpy as np
import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_FIXTURE_DIR = REPO_ROOT / "tests" / "data"
DEFAULT_OUT_DIR = REPO_ROOT / "results" / "torch"

#: per-fixture weight transform: the paper metric (MC64 log2-scaled, lifted
#: non-negative) where magnitudes span decades; |a_ij| for the symmetric /
#: integer fixtures; pattern files are already unit-weight.
FIXTURE_TRANSFORMS = {
    "circuit8": "log2_scaled_nonneg",
    "bands6_sym": "abs",
    "mesh5_pat": None,
    "count4_int": "abs",
    "illcond9": "log2_scaled_nonneg",
    "zcoil7": "log2_scaled_nonneg",
}

#: the local backends swept (each pinned), then "auto"
LOCAL_BACKENDS = ("reference", "torch", "cuda", "cuda_persistent")
DEFAULT_BACKENDS = LOCAL_BACKENDS + ("auto",)
#: the grids swept on the CPU; the card runs the 1x1 grid alone (one card)
GRIDS = ((1, 1), (2, 2))

#: a spawned grid's deadline
GRID_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class EvalCase:
    """One instance to evaluate: a built problem + reporting metadata."""

    name: str
    problem: object  # MatchingProblem, single instance
    source: str  # "fixture" | "synthetic"
    transform: str  # weight metric label for the table
    nnz: int


@dataclasses.dataclass
class EvalRecord:
    """One (case, engine) measurement: a row of the per-matrix table."""

    name: str
    source: str
    transform: str
    engine: str  # a backend, "auto", or "grid{pr}x{pc}"
    n: int
    nnz: int
    weight: float
    upper_bound: float
    ratio_bound: float | None  # certified lower bound on weight/OPT
    ratio_exact: float | None  # vs ref.exact_mwpm when tractable
    tight: bool
    awac_iters: int
    wall_s: float
    perfect: bool
    identical_to_reference: bool
    certified_sound: bool  # bound >= exact optimum (True when no oracle ran)
    backend: str = ""  # the engine that ran (ExecutionInfo.backend)
    dispatch: str = ""  # how it was chosen (ExecutionInfo.source)
    device: str = ""


def fixture_cases(fixture_dir=None, device=None) -> list[EvalCase]:
    """Load every ``.mtx`` fixture with its paper-metric transform
    (unknown files default to ``abs``)."""
    from repro_torch.data.mtx import load_problem

    fixture_dir = pathlib.Path(fixture_dir or DEFAULT_FIXTURE_DIR)
    cases = []
    for path in sorted(fixture_dir.glob("*.mtx")):
        transform = FIXTURE_TRANSFORMS.get(path.stem, "abs")
        problem, coo = load_problem(path, transform=transform, device=device)
        cases.append(EvalCase(
            name=path.stem, problem=problem, source="fixture",
            transform=transform or "pattern", nnz=coo.nnz))
    if not cases:
        raise FileNotFoundError(f"no .mtx fixtures under {fixture_dir}")
    return cases


def synthetic_cases(count: int = 10, n: int = 96, transform=None,
                    device=None) -> list[EvalCase]:
    """A slice of the synthetic suite (already row/column normalised; pass
    ``transform`` to re-measure it in another metric, such as the paper's
    log2-scaled one)."""
    from repro_torch.core.api import MatchingProblem
    from repro_torch.core.graph import matrix_suite
    from repro_torch.data.weight_transforms import get_transform

    cases = []
    for name, g in matrix_suite(n_matrices=count, n=n):
        if transform is None:
            problem = MatchingProblem.from_graph(g, device=device)
            label = "rowcol"
        else:
            mask = np.arange(g.capacity) < g.nnz
            row, col = g.row[mask], g.col[mask]
            val = get_transform(transform)(row, col, g.val[mask], g.n)
            problem = MatchingProblem.from_coo(row, col, val, g.n,
                                               device=device)
            label = transform if isinstance(transform, str) else "custom"
        cases.append(EvalCase(name=name, problem=problem, source="synthetic",
                              transform=label, nnz=g.nnz))
    return cases


def _exact_optimum(case: EvalCase):
    """ref.exact_mwpm on a densified instance, or None when intractable."""
    from repro_torch.core import ref

    if not ref.HAVE_SCIPY:
        return None
    p = case.problem
    n = p.n
    row, col, val = (x.cpu().numpy() for x in (p.row, p.col, p.val))
    m = (row < n) & (col < n)
    dense = np.zeros((n, n), np.float32)
    struct = np.zeros((n, n), bool)
    dense[row[m], col[m]] = val[m]
    struct[row[m], col[m]] = True
    _, opt = ref.exact_mwpm(dense, struct)
    return float(opt)


def _record(case: EvalCase, engine: str, res, wall_s: float, opt,
            ref_mate, tol: float = 1e-5) -> EvalRecord:
    from repro_torch.core.dual import certify

    cert = certify(case.problem, res)
    mate = res.mate_row.cpu().numpy()
    identical = bool(np.array_equal(mate, ref_mate)) \
        if ref_mate is not None else True
    scale = max(1.0, abs(opt)) if opt is not None else 1.0
    sound = True if opt is None else \
        bool(cert.upper_bound >= opt - tol * scale)
    ratio_exact = None if opt in (None, 0.0) else float(cert.weight / opt)
    ex = res.execution
    return EvalRecord(
        name=case.name, source=case.source, transform=case.transform,
        engine=engine, n=case.problem.n, nnz=case.nnz,
        weight=float(cert.weight), upper_bound=float(cert.upper_bound),
        ratio_bound=cert.ratio_bound_or(None), ratio_exact=ratio_exact,
        tight=bool(cert.tight), awac_iters=int(res.awac_iters),
        wall_s=float(wall_s), perfect=bool(res.perfect),
        identical_to_reference=identical, certified_sound=sound,
        backend=ex.backend, dispatch=ex.source, device=ex.device)


def _check(rec: EvalRecord) -> None:
    problems = []
    if not rec.perfect:
        problems.append("matching is not perfect")
    if not rec.certified_sound:
        problems.append(
            f"UNSOUND certificate: upper_bound={rec.upper_bound:.6f} < "
            f"exact optimum")
    if not rec.identical_to_reference:
        problems.append("result differs from the reference backend")
    if problems:
        raise AssertionError(
            f"paper_eval {rec.name} [{rec.engine}]: " + "; ".join(problems))


def _case_aux(case: EvalCase, oracle_max_n: int) -> tuple:
    """The per-case baseline, computed once per sweep: the exact optimum
    (when tractable) and the "reference" backend's mates, which every
    other engine must match bit for bit, even when "reference" is not
    itself among the swept backends."""
    from repro_torch.core.api import SolveOptions, solve

    opt = _exact_optimum(case) if case.problem.n <= oracle_max_n else None
    ref_res = solve(case.problem, SolveOptions(backend="reference"))
    return opt, ref_res.mate_row.cpu().numpy()


def _timed(fn, device):
    """(result, seconds) of a later call of ``fn``: one call first, then
    the timed one, which ends in a device sync."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return res, time.perf_counter() - t0


def _eval_local(case: EvalCase, backends: Sequence[str],
                aux: tuple) -> list[EvalRecord]:
    from repro_torch.core.api import SolveOptions, solve

    opt, ref_mate = aux
    records = []
    for backend in backends:
        opts = SolveOptions(backend=backend)
        res, wall = _timed(lambda: solve(case.problem, opts),
                           case.problem.device)
        rec = _record(case, backend, res, wall, opt, ref_mate)
        _check(rec)
        records.append(rec)
    return records


def _cases_from_spec(spec: dict, device=None) -> list[EvalCase]:
    """The case list of a JSON-able spec: the same dict drives this
    process's sweep and the spawned grid ranks, so every side holds the
    identical (deterministic) cases."""
    cases = []
    if spec.get("fixtures", True):
        cases += fixture_cases(spec.get("fixture_dir"), device=device)
    if spec.get("synthetic_count", 0):
        cases += synthetic_cases(spec["synthetic_count"],
                                 spec.get("synthetic_n", 96),
                                 spec.get("synthetic_transform"),
                                 device=device)
    keep = spec.get("names")
    if keep is not None:
        cases = [c for c in cases if c.name in set(keep)]
    return cases


def _eval_grid_inproc(cases, grid, oracle_max_n,
                      aux_by_name=None) -> list[EvalRecord]:
    """Every case through ``plan()`` and a ``Matcher`` call on ``grid``
    (a ``GridSpec`` this process holds a rank of)."""
    from repro_torch.core.api import SolveOptions, plan

    engine = f"grid{grid.pr}x{grid.pc}"
    records = []
    for case in cases:
        opt, ref_mate = (aux_by_name or {}).get(case.name) or \
            _case_aux(case, oracle_max_n)
        matcher = plan(case.problem, SolveOptions(grid=grid))
        res, wall = _timed(lambda: matcher(case.problem), grid.device)
        rec = _record(case, engine, res, wall, opt, ref_mate)
        _check(rec)
        records.append(rec)
    return records


def _grid_rank_main(rank: int, pr: int, pc: int, spec_json: str,
                    oracle_max_n: int, workdir: str):
    """One spawned gloo rank of a pr x pc grid: the cases of the spec,
    every ``Matcher`` call of the sweep; its records written to
    ``workdir``."""
    import torch.distributed as tdist

    from repro_torch.core.dist import make_grid

    torch.set_num_threads(1)
    work = pathlib.Path(workdir)
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(work / "store"), pr * pc),
        rank=rank, world_size=pr * pc,
        timeout=datetime.timedelta(seconds=60))
    try:
        grid = make_grid(pr, pc, device="cpu")
        cases = _cases_from_spec(json.loads(spec_json), device="cpu")
        records = _eval_grid_inproc(cases, grid, oracle_max_n)
        out = [dataclasses.asdict(r) for r in records]
    except Exception as e:  # the parent raises it
        out = {"raised": f"{type(e).__name__}: {e}"}
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    tdist.barrier()
    tdist.destroy_process_group()


def _eval_grid_spawned(spec: dict, grid: tuple[int, int], oracle_max_n: int,
                       n_cases: int) -> list[EvalRecord]:
    """A pr x pc grid as pr * pc spawned gloo ranks on the CPU. Every rank
    must return the same records (timings aside); rank 0's are kept."""
    import torch.multiprocessing as mp

    pr, pc = grid
    with tempfile.TemporaryDirectory(prefix="awpm-eval-") as work:
        ctx = mp.start_processes(
            _grid_rank_main,
            args=(pr, pc, json.dumps(spec), oracle_max_n, work),
            nprocs=pr * pc, join=False, start_method="spawn")
        deadline = time.monotonic() + GRID_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"grid {pr}x{pc}: the ranks did not finish within "
                        f"{GRID_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        per_rank = [json.loads((pathlib.Path(work) / f"rank{r}.json")
                               .read_text()) for r in range(pr * pc)]
    for r, out in enumerate(per_rank):
        if isinstance(out, dict):
            raise RuntimeError(f"grid {pr}x{pc} rank {r}: {out['raised']}")
    untimed = [[{k: v for k, v in rec.items() if k != "wall_s"}
                for rec in out] for out in per_rank]
    if any(u != untimed[0] for u in untimed[1:]):
        raise RuntimeError(f"grid {pr}x{pc}: the ranks disagree")
    records = [EvalRecord(**rec) for rec in per_rank[0]]
    if len(records) != n_cases:
        raise RuntimeError(f"grid {pr}x{pc}: {len(records)} rows for "
                           f"{n_cases} cases")
    return records


def _eval_grid(cases, spec, grid, oracle_max_n, aux_by_name, device):
    """One grid's rows for every case: the 1x1 grid in this process, a
    larger one as spawned gloo ranks (the CPU only: one card holds one
    NCCL rank)."""
    from repro_torch.core.dist import make_grid

    pr, pc = grid
    if (pr, pc) == (1, 1):
        return _eval_grid_inproc(cases, make_grid(1, 1, device=device),
                                 oracle_max_n, aux_by_name)
    if device.type != "cpu":
        raise ValueError(
            f"a {pr}x{pc} grid needs {pr * pc} cards; the card runs the 1x1 "
            f"grid (device='cpu' spawns gloo ranks)")
    return _eval_grid_spawned(spec, grid, oracle_max_n, len(cases))


DEFAULT_SPEC = {"fixtures": True, "synthetic_count": 10, "synthetic_n": 96}
QUICK_SPEC = {"fixtures": True, "synthetic_count": 3, "synthetic_n": 48}


def run_eval(spec: dict | None = None,
             backends: Sequence[str] = DEFAULT_BACKENDS,
             grids: Sequence[tuple[int, int]] | None = None,
             oracle_max_n: int = 256, device=None) -> list[EvalRecord]:
    """The sweep: every case of ``spec`` (default :data:`DEFAULT_SPEC`)
    through the ``backends`` and the process ``grids`` (default
    :data:`GRIDS` on the CPU, the 1x1 grid on the card), on ``device``
    (None: the card, raising without one). Raises on any soundness,
    bit-identity or perfection violation (see the module docstring)."""
    from repro_torch.core.single import resolve_device

    device = resolve_device(device)
    spec = dict(DEFAULT_SPEC if spec is None else spec)
    if grids is None:
        grids = GRIDS if device.type == "cpu" else ((1, 1),)
    cases = _cases_from_spec(spec, device=device)
    aux_by_name = {c.name: _case_aux(c, oracle_max_n) for c in cases}
    records = []
    for case in cases:
        records += _eval_local(case, backends, aux_by_name[case.name])
    for grid in grids:
        records += _eval_grid(cases, spec, tuple(grid), oracle_max_n,
                              aux_by_name, device)
    return records


# --------------------------------------------------------------------------
# outputs: the per-matrix markdown table and the JSON record
# --------------------------------------------------------------------------


def _fmt_ratio(x) -> str:
    # None: no valid certified bound (dual.bound_valid was False)
    if x is None or x != x:
        return "-"
    return f"{x:.4f}"


def _engine_label(r: EvalRecord) -> str:
    if r.engine == "auto":
        return f"auto ({r.backend}, {r.dispatch})"
    return r.engine


def to_markdown(records: Sequence[EvalRecord]) -> str:
    lines = [
        "# Paper evaluation: AWPM quality per matrix (torch port)",
        "",
        "Generated by `python -m repro_torch.experiments`. `ratio>=` is the "
        "LP-dual certified lower bound on weight/OPT (tight=True: certified "
        "optimal); `ratio` is vs the exact oracle where tractable; `ms` is "
        "a later call's wall time.",
        "",
        "| matrix | src | metric | engine | n | nnz | weight | bound "
        "| ratio>= | ratio | tight | iters | ms |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        lines.append(
            f"| {r.name} | {r.source} | {r.transform} | {_engine_label(r)} "
            f"| {r.n} | {r.nnz} | {r.weight:.4f} | {r.upper_bound:.4f} "
            f"| {_fmt_ratio(r.ratio_bound)} | {_fmt_ratio(r.ratio_exact)} "
            f"| {r.tight} | {r.awac_iters} | {r.wall_s * 1e3:.3f} |")
    return "\n".join(lines) + "\n"


def to_bench_rows(records: Sequence[EvalRecord]) -> list[dict]:
    """Rows in the JAX runner's schema (name / us_per_call / derived),
    with the ``certified_sound`` and ``identical_to_reference`` flags."""
    rows = []
    for r in records:
        derived = (
            f"weight={r.weight:.4f};bound={r.upper_bound:.4f};"
            f"ratio_bound={_fmt_ratio(r.ratio_bound)};"
            f"iters={r.awac_iters};tight={r.tight};"
            f"certified_sound={r.certified_sound};"
            f"identical_to_reference={r.identical_to_reference}")
        if r.ratio_exact is not None:
            derived += f";ratio_exact={r.ratio_exact:.4f}"
        if r.engine == "auto":
            derived += f";backend={r.backend};dispatch={r.dispatch}"
        rows.append({"name": f"paper_eval_{r.name}_{r.engine}",
                     "us_per_call": round(r.wall_s * 1e6, 1),
                     "derived": derived})
    return rows


def host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it (its model name, or its
    vendor, family and model where a virtual machine reports the name as
    unknown), the machine type and the logical cores."""
    info = {}
    try:
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            key, _, val = line.partition(":")
            info.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name == "unknown" and "vendor_id" in info:
        name = (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')}")
    return f"{name} ({platform.machine()}), {os.cpu_count()} logical cores"


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    "not available"."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "not available"


def device_description(device) -> dict:
    """What ran the sweep: the card's name and power limit, or the host
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return {"device": "cuda", "card": card(),
                "name": torch.cuda.get_device_name(device)}
    return {"device": "cpu", "cpu": host_cpu()}


def write_outputs(records: Sequence[EvalRecord], wall_clock_s: float,
                  out_dir=None, quick: bool = False, device="cpu"):
    """Write ``paper_eval.md`` and ``paper_eval.json`` into ``out_dir``
    (default ``results/torch/``). Returns their paths."""
    out_dir = pathlib.Path(out_dir or DEFAULT_OUT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    table = out_dir / "paper_eval.md"
    table.write_text(to_markdown(records))
    rec = {
        "suite": "paper_eval",
        "ok": True,
        "wall_clock_s": round(wall_clock_s, 3),
        "rows": to_bench_rows(records),
        "records": [dataclasses.asdict(r) for r in records],
        "metadata": {
            "date": datetime.datetime.now(datetime.timezone.utc).isoformat(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "quick": quick,
            **device_description(device),
        },
    }
    bench = out_dir / "paper_eval.json"
    bench.write_text(json.dumps(rec, indent=1))
    return table, bench
