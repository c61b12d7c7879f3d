"""Distributed-memory AWPM on a 2D process grid over ``torch.distributed``.

The paper's Pr x Pc process grid is one rank per block, in row-major
order: rank ``a * pc + b`` owns the dense index block rows
[a*br, (a+1)*br) x cols [b*bc, (b+1)*bc). The program is SPMD: every rank
calls ``solve()``/``Matcher`` on the same full problem, partitions it on
the host (``sparse.partition.partition_coo_2d_batched``, deterministic)
and keeps its own [B, cap_blk] block on its device. The O(n) matching
state (mates, u, v, winners) is [B, n + 1], replicated and updated
identically on every rank, so the result is replicated too, and every
loop's predicate is read from replicated state: every rank runs the same
rounds.

Communication per AWAC round (paper Steps A-D):
  A/B: two bucketed fixed-capacity ``all_to_all_single``s (first within
       the grid row, to the grid column that owns j' = mate_col[r], then
       within the grid column, to the grid row that owns i' = mate_row[c])
       carrying the relabeled completion edges (i', j', w) — the nonzeros
       of M A^T M.
  C:   ``all_gather`` of the per-local-column winners within the grid
       column, a lexicographic pick, then ``all_gather`` within the grid
       row to replicate the winners.
  D:   the replicated ``single.select_and_augment`` (shared code).

The greedy proposals and the MCM's BFS parents are reduced the same way,
and the loops are ``core.batch``'s skeletons, so the engine is
bit-identical per instance to the batched engine by construction.

A 1x1 grid still runs every collective, with one peer. On the card the
groups run NCCL; gloo runs them only when the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import tempfile
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import batch, single
from repro_torch.core.constants import MIN_GAIN
from repro_torch.core.single import I32, NEG, MatchState
from repro_torch.kernels.cycle_gain.awac_sweep import SweepScratch
from repro_torch.sparse.csr import batched_row_ptr_from_sorted, window_depth
from repro_torch.sparse.ops import (
    batched_searchsorted_in_window,
    batched_segment_argmax_tie,
    lex_searchsorted,
)
from repro_torch.sparse.partition import partition_coo_2d_batched

#: how long a collective may wait for its peers before the group fails
TIMEOUT = datetime.timedelta(seconds=60)

# the concatenating all_gather: newer torch names it all_gather_single
_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: hashed by identity
class GridSpec:
    """This rank's place on the Pr x Pc process grid.

    ``row_group`` holds the ranks of this rank's grid row (a * pc + 0 ..
    pc - 1; its group rank is the grid column); ``col_group`` those of its
    grid column (0 .. pr - 1 times pc, plus b; its group rank is the grid
    row). A pod axis folds into the grid rows. Collectives over the whole
    grid run on ``group``: None means the default group, whose size is
    then pr * pc; a grid over a subset of the ranks (``make_subgrid``)
    holds the group of its own ranks. Build it with :func:`make_grid` or
    :func:`make_subgrid`."""

    pr: int
    pc: int
    a: int
    b: int
    row_group: Any
    col_group: Any
    device: torch.device
    group: Any = None

    @property
    def rank(self) -> int:
        return self.a * self.pc + self.b

    def __repr__(self):
        return (f"GridSpec({self.pr}x{self.pc}, rank {self.rank} at "
                f"({self.a}, {self.b}), {self.device})")


_GRIDS: dict = {}


def make_grid(pr: int, pc: int, device=None) -> GridSpec:
    """The Pr x Pc grid over the default process group, for this rank.

    Uses the default group when one is initialised; its world size must be
    pr * pc. A 1x1 grid with no group starts a one-rank group itself, on a
    ``FileStore`` in a temporary directory. ``device=None`` means the card
    (NCCL); ``device="cpu"`` runs the collectives over gloo. Every rank
    must call this with the same arguments, in the same order: it creates
    every row and column group with ``dist.new_group``."""
    if isinstance(pr, bool) or isinstance(pc, bool) or int(pr) < 1 \
            or int(pc) < 1:
        raise ValueError(f"bad grid shape {pr}x{pc}")
    pr, pc = int(pr), int(pc)
    device, want = _grid_device(device)
    if not dist.is_initialized():
        if (pr, pc) != (1, 1):
            raise ValueError(
                f"a {pr}x{pc} grid needs an initialised default process "
                f"group of {pr * pc} ranks (torch.distributed."
                f"init_process_group); only the 1x1 grid starts its own")
        store = dist.FileStore(
            tempfile.mkdtemp(prefix="awpm-grid-") + "/store", 1)
        dist.init_process_group(
            want, store=store, rank=0, world_size=1, timeout=TIMEOUT,
            device_id=device if device.type == "cuda" else None)
    world = dist.get_world_size()
    if world != pr * pc:
        raise ValueError(
            f"the default process group has {world} ranks, a {pr}x{pc} grid "
            f"needs {pr * pc}")
    return make_subgrid(np.arange(pr * pc).reshape(pr, pc), device)


def _grid_device(device):
    """(the grid's device, the backend its collectives need)."""
    device = single.resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device, "nccl" if device.type == "cuda" else "gloo"


def _check_backend(device, want: str) -> None:
    have = str(dist.get_backend())
    if want not in have:
        raise ValueError(
            f"the default process group runs {have!r}; a grid on {device} "
            f"needs {want!r}")


def make_subgrid(ranks, device=None) -> GridSpec | None:
    """The grid over a rectangle of the default group's ranks:
    ``ranks[a][b]`` is the global rank that owns block (a, b), in
    increasing order row by row (a survivor rectangle of a ``make_grid``
    grid keeps that order). The grid's collectives run on a group of
    those ranks alone (``GridSpec.group``).

    Every rank of the default group must call this with the same
    arguments, in the same order, inside the rectangle or not:
    ``dist.new_group`` builds the grid's group and its row and column
    groups, and every rank takes part in each. Returns this rank's
    :class:`GridSpec`, or None for a rank outside the rectangle."""
    ranks = np.asarray(ranks, dtype=np.int64)
    if ranks.ndim != 2 or ranks.size == 0:
        raise ValueError(
            f"ranks must be a non-empty [pr, pc] array, got shape "
            f"{ranks.shape}")
    if not dist.is_initialized():
        raise ValueError("a subgrid needs an initialised default process "
                         "group (torch.distributed.init_process_group)")
    device, want = _grid_device(device)
    _check_backend(device, want)
    flat = ranks.reshape(-1).tolist()
    world = dist.get_world_size()
    if flat != sorted(set(flat)) or flat[0] < 0 or flat[-1] >= world:
        raise ValueError(
            f"ranks {ranks.tolist()} must be distinct ranks of the "
            f"{world}-rank default group, increasing row by row")
    key = ("sub", tuple(flat), ranks.shape, str(device))
    cached = _GRIDS.get(key)
    if cached is not None and cached[0] is dist.group.WORLD:
        return cached[1]
    pr, pc = ranks.shape
    # the whole default group needs no group of its own
    whole = None if flat == list(range(world)) else dist.new_group(flat)
    rows = [dist.new_group(ranks[r].tolist()) for r in range(pr)]
    cols = [dist.new_group(ranks[:, c].tolist()) for c in range(pc)]
    spec = None
    me = dist.get_rank()
    if me in flat:
        a, b = divmod(flat.index(me), pc)
        spec = GridSpec(pr, pc, a, b, rows[a], cols[b], device, group=whole)
    _GRIDS[key] = (dist.group.WORLD, spec)
    return spec


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------


def _all_gather(x, group, size: int):
    """[size, *x.shape]: every group member's ``x``, in group-rank order."""
    x = x.contiguous()
    out = torch.empty(size * x.numel(), dtype=x.dtype, device=x.device)
    _all_gather_flat(out, x.reshape(-1), group=group)
    return out.view(size, *x.shape)


def _gather_n(x, group, size: int, n: int):
    """all_gather [B, k] within ``group`` -> replicated [B, n]: the
    members' slices concatenated in group-rank order, the padded tail cut
    off."""
    g = _all_gather(x, group, size)
    return g.movedim(0, 1).reshape(x.shape[0], -1)[:, :n]


def _lex_pick(G, TIE, payloads, tie_fill: int):
    """Per column, the largest G and on a tie the smallest TIE, across the
    leading member axis. G [D, B, k] float, TIE [D, B, k] int. Returns
    (g, tie, picked payloads), each [B, k]. An empty column (all -inf)
    gives (-inf, tie_fill, the payloads of member 0)."""
    g0 = G.amax(dim=0)
    hit = (G == g0[None]) & (g0[None] > NEG)
    t0 = torch.where(hit, TIE, tie_fill).amin(dim=0)
    hit2 = hit & (TIE == t0[None])
    member = hit2.to(torch.int32).argmax(dim=0)  # the first hit
    out = [p.gather(0, member[None]).squeeze(0) for p in payloads]
    return g0, t0, out


class ExchangeIntegrityError(RuntimeError):
    """The two-stage bucketed exchange lost, duplicated, or corrupted
    payloads: the result would not be bit-identical to the local engines.
    Raised by ``api._solve_dist`` on a non-zero dropped counter (undersized
    user a2a_caps) or a failed ``SolveOptions(exchange_check=True)``
    conservation audit."""


# Exchange hook for a fault-injection harness: when set, called as
# ``tap(stage, outs, valid) -> (outs, valid)`` on every exchange's received
# buffers, with stage 1 (within the grid row) or 2 (within the grid
# column). None in production.
_EXCHANGE_TAP = None


def _tapped(stage: int, outs, valid):
    if _EXCHANGE_TAP is None:
        return outs, valid
    return _EXCHANGE_TAP(stage, outs, valid)


def _conserved(arrays, valid):
    """Order-independent conservation signature of an exchange payload:
    (count of valid entries, int64 sum of the valid payloads' int32 bit
    patterns). The two-stage exchange only routes (i, j, w) triples, so
    both are conserved end to end when nothing is dropped: a drop or a
    duplicate changes the count, a corruption (an injected NaN too) the
    sum."""
    cnt = valid.sum(dtype=torch.int64)
    chk = torch.zeros((), dtype=torch.int64, device=valid.device)
    for a in arrays:
        bits = a if a.dtype == torch.int32 else a.contiguous().view(torch.int32)
        chk = chk + torch.where(valid, bits, 0).sum(dtype=torch.int64)
    return cnt, chk


def a2a_bucketed_batched(arrays, fills, dest, valid, n_peers: int,
                         cap_out: int, group, stage: int,
                         packed: bool = False):
    """Fixed-capacity bucketed all_to_all for B instances at once.

    arrays: [B, L] payloads with their padding values ``fills``; dest
    [B, L] in [0, n_peers); valid [B, L] bool. Each instance's entries are
    bucketed by destination (a stable sort keeps their order) into
    [n_peers, B, cap_out] buffers, and one ``all_to_all_single`` per
    payload (one in all when ``packed``: float payloads travel as their
    int32 bits, and validity is read from the first payload's fill)
    carries every instance's buckets. Entries beyond ``cap_out`` in a
    bucket are written to one extra slot that is then cut off, and counted.

    Returns (received arrays, each [B, n_peers * cap_out], received valid,
    dropped count on this rank as an int64 scalar)."""
    b, L = dest.shape
    dev = dest.device
    d = torch.where(valid, dest, n_peers)
    order = torch.argsort(d, dim=1, stable=True)
    ds = d.gather(1, order)
    peers = torch.arange(n_peers, dtype=ds.dtype, device=dev)
    start = torch.searchsorted(ds.contiguous(),
                               peers.expand(b, n_peers).contiguous())
    posin = torch.arange(L, dtype=torch.int64, device=dev)[None, :] \
        - start.gather(1, ds.clamp(0, n_peers - 1).long())
    real = ds < n_peers
    ok = real & (posin < cap_out)
    slot = torch.where(ok, ds.long() * cap_out + posin, n_peers * cap_out)
    dropped = real.sum(dtype=torch.int64) - ok.sum(dtype=torch.int64)

    def fill_buf(a, fv):
        buf = torch.full((b, n_peers * cap_out + 1), fv, dtype=a.dtype,
                         device=dev)
        buf.scatter_(1, slot, a.gather(1, order))
        return buf[:, :-1]

    def exchange(x):
        shp = x.shape
        x = x.reshape(b, n_peers, cap_out, *shp[2:]).movedim(1, 0)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out.movedim(0, 1).reshape(shp)

    if packed:
        cols = [fill_buf(a, fv) for a, fv in zip(arrays, fills)]
        cols = [c if c.dtype == torch.int32 else c.view(torch.int32)
                for c in cols]
        recv = exchange(torch.stack(cols, dim=-1))
        outs = [recv[..., i] if a.dtype == torch.int32
                else recv[..., i].contiguous().view(a.dtype)
                for i, a in enumerate(arrays)]
        # validity from the first payload's sentinel (mate ids fill n)
        outs, vrecv = _tapped(stage, outs, outs[0] != fills[0])
        return outs, vrecv, dropped
    outs = [exchange(fill_buf(a, fv)) for a, fv in zip(arrays, fills)]
    vbuf = torch.zeros((b, n_peers * cap_out + 1), dtype=torch.int32,
                       device=dev)
    vbuf.scatter_(1, slot, ok.to(torch.int32))
    outs, vrecv = _tapped(stage, outs, exchange(vbuf[:, :-1]).bool())
    return outs, vrecv, dropped


def safe_a2a_caps(cap_blk: int, pr: int, pc: int) -> tuple[int, int]:
    """Bucket capacities that make the two-stage exchange drop-free:
    stage 1 can at worst route every local edge to one column peer
    (cap1 = cap_blk); stage 2 at worst forwards everything it received to
    one row peer (cap2 = pc * cap1). Bit-identity with the batched engine
    needs every candidate delivered, so these are the defaults."""
    return cap_blk, pc * cap_blk


#: the engine's backends. "fused" joins the exchanged candidates against
#: the local block by a CSR-windowed search, "reference" by a global lex
#: search per block; "torch" and "cuda" need the 1x1 grid and run Steps
#: A+B+C through ``core.batch``'s sweep (the plain one, or the sweep kernel).
DIST_BATCHED_BACKENDS = ("fused", "reference", "torch", "cuda")


def _take(x, idx):
    return x.gather(1, idx.long())


@functools.lru_cache(maxsize=None)
def _make_awpm_dist_batched(spec: GridSpec, n: int, b: int, cap: int,
                            a2a_caps: tuple[int, int], max_iter: int = 1000,
                            min_gain: float = MIN_GAIN, packed: bool = False,
                            backend: str = "fused",
                            window_steps: int | None = None,
                            from_state: bool = False,
                            degrade_infeasible: bool = False,
                            exchange_check: bool = False):
    """Build the distributed-batched AWPM for this rank's blocks.

    The engine runs greedy maximal -> MCM -> dual build -> AWAC for all B
    instances through ``core.batch``'s loop skeletons (``greedy_loop``,
    ``mcm_loop``, ``awac_loop``), with only the per-round winners computed
    from 2D blocks and collectives, so it is bit-identical per instance to
    ``core.batch._awpm_batched``.

    Returns ``run(brow, bcol, bval, split=None) -> (MatchState with
    [B, n + 1] fields, iters [B], aux)`` over this rank's [B, cap] block;
    aux is the global dropped count (int64), or with ``exchange_check``
    the pair [dropped, rounds that failed the audit]. ``split``, a dict,
    receives the seconds of each phase (each ending in a device sync).
    With ``from_state=True`` the runner takes a replicated initial state
    ``run(brow, bcol, bval, mate_row, mate_col, u, v)`` and runs the AWAC
    phase only.
    """
    pr, pc = spec.pr, spec.pc
    if backend not in DIST_BATCHED_BACKENDS:
        raise ValueError(f"unknown dist AWAC backend {backend!r}")
    if backend in ("torch", "cuda") and (pr, pc) != (1, 1):
        raise ValueError(
            f"backend {backend!r} routes through core.batch's local sweep "
            f"and needs the 1x1 grid, got {pr}x{pc}")
    br = -(-n // pr)
    bc = -(-n // pc)
    cap1, cap2 = a2a_caps
    adev, bdev = spec.a, spec.b
    rows_g, cols_g = spec.row_group, spec.col_group
    if window_steps is None:
        window_steps = window_depth(cap)

    def run(brow, bcol, bval, *state_args, split=None):
        dev = brow.device
        mg = single._min_gain_tensor(min_gain, dev)
        # per-instance CSR row_ptr over this rank's global rows
        # [adev*br, (adev+1)*br); the padding tail sits beyond bptr[:, br]
        targets = adev * br + torch.arange(br + 1, dtype=brow.dtype,
                                           device=dev)
        bptr = torch.searchsorted(brow.contiguous(),
                                  targets.expand(b, br + 1).contiguous(),
                                  out_int32=True)

        def greedy_propose(mate_row, mate_col):
            avail = (brow < n) & (_take(mate_col, brow) == n) \
                & (_take(mate_row, bcol) == n)
            lj = torch.where(avail, bcol - bdev * bc, bc)
            score = torch.where(avail, bval, NEG)
            pg, pidx = batched_segment_argmax_tie(score, brow, lj, bc + 1)
            has = pidx[:, :bc] >= 0
            pi_loc = torch.where(has, _take(brow, pidx[:, :bc].clamp(min=0)),
                                 n)
            G = _all_gather(pg[:, :bc], cols_g, pr)
            I_ = _all_gather(pi_loc, cols_g, pr)
            g0, i0, _ = _lex_pick(G, I_, [], n)
            pv = _gather_n(g0, rows_g, pc, n)
            prow = _gather_n(i0, rows_g, pc, n)
            return pv, torch.where(pv > NEG, prow, n)

        def mcm_parents(frontier, visited):
            elig = (brow < n) & _take(frontier, bcol) \
                & ~_take(visited, brow)
            li = torch.where(elig, brow - adev * br, br)
            score = torch.where(elig, bval, NEG)
            rg, ridx = batched_segment_argmax_tie(score, bcol, li, br + 1)
            has = ridx[:, :br] >= 0
            rc_loc = torch.where(has, _take(bcol, ridx[:, :br].clamp(min=0)),
                                 n)
            # a row's edges live in ONE grid row, spread over its columns
            G = _all_gather(rg[:, :br], rows_g, pc)
            C = _all_gather(rc_loc, rows_g, pc)
            g0, c0, _ = _lex_pick(G, C, [], n)
            pval = _gather_n(g0, cols_g, pr, n)
            pcol = _gather_n(c0, cols_g, pr, n)
            return pval > NEG, pcol

        def uv_state(mate_row, mate_col):
            gi = (adev * br + torch.arange(br, dtype=I32, device=dev)) \
                .expand(b, br)
            gis = gi.clamp(0, n)
            q = _take(mate_col, gis)
            pos, found = batched_searchsorted_in_window(
                bcol, q, bptr[:, :br], bptr[:, 1:], n_steps=window_steps)
            w = torch.where(found & (gi < n),
                            _take(bval, pos.clamp(0, cap - 1)), 0.0)
            # each matched edge (i, mate_col[i]) lives in exactly one
            # block: the sum over ranks adds its weight to exact zeros
            u = torch.zeros(b, n + 1, dtype=torch.float32, device=dev)
            u.scatter_(1, torch.where(gi < n, gis, n).long(), w)
            dist.all_reduce(u, group=spec.group)
            u[:, n] = 0.0
            v = torch.zeros(b, n + 1, dtype=torch.float32, device=dev)
            mr = mate_row[:, :n]
            v[:, :n] = torch.where(mr < n, _take(u, mr.clamp(0, n)), 0.0)
            return MatchState(mate_row, mate_col, u, v)

        def cwinners(state):
            mate_row, mate_col, u, v = state
            i2 = _take(mate_row, bcol)
            j2 = _take(mate_col, brow)
            valid = (brow < n) & (i2 < n) & (j2 < n)
            if exchange_check:
                cnt_in, chk_in = _conserved([i2, j2, bval], valid)
            # stage 1: to the grid column that owns j2
            (o_i, o_j, o_w), v1, d1 = a2a_bucketed_batched(
                [i2, j2, bval], [n, n, 0.0], torch.div(j2, bc,
                                                       rounding_mode="floor"),
                valid, pc, cap1, rows_g, 1, packed=packed)
            # stage 2: to the grid row that owns o_i
            (qi, qj, qw2), qvalid, d2 = a2a_bucketed_batched(
                [o_i, o_j, o_w], [n, n, 0.0],
                torch.div(o_i, br, rounding_mode="floor"), v1, pr, cap2,
                cols_g, 2, packed=packed)
            if exchange_check:
                # the exchange only routes (i, j, w) triples: the global
                # count (less capacity drops) and, when nothing dropped,
                # the order-free checksum must balance every round
                cnt_out, chk_out = _conserved([qi, qj, qw2], qvalid)
                tot = torch.stack([cnt_in, chk_in, cnt_out, chk_out,
                                   d1 + d2])
                dist.all_reduce(tot, group=spec.group)
                bad = ((tot[0] - tot[4]) != tot[2]) \
                    | ((tot[4] == 0) & (tot[1] != tot[3]))
                aux = torch.stack([tot[4], bad.to(torch.int64)])
            else:
                aux = d1 + d2
            if backend == "reference":
                found_pos = [lex_searchsorted(brow[k], bcol[k], qi[k], qj[k],
                                              n_steps=window_depth(cap))
                             for k in range(b)]
                pos = torch.stack([p for p, _ in found_pos])
                found = torch.stack([f for _, f in found_pos])
            else:  # the batched CSR-windowed search
                li = (qi - adev * br).clamp(0, br - 1)
                in_row = qvalid & (qi - adev * br == li)
                lo = _take(bptr, li)
                hi = torch.where(in_row, _take(bptr, li + 1), lo)
                pos, found = batched_searchsorted_in_window(
                    bcol, qj, lo, hi, n_steps=window_steps)
            w1 = _take(bval, pos.clamp(0, cap - 1))
            gain = w1 + qw2 - _take(u, qi.clamp(0, n)) \
                - _take(v, qj.clamp(0, n))
            cand = qvalid & found & (gain > mg) \
                & (qi > _take(mate_row, qj.clamp(0, n)))
            # Step C: per-local-column winner (max gain, tie min row)
            lj = torch.where(cand, qj - bdev * bc, bc)
            gm = torch.where(cand, gain, NEG)
            cg, cidx = batched_segment_argmax_tie(gm, qi, lj, bc + 1)
            sel = cidx[:, :bc].clamp(min=0)
            has = cidx[:, :bc] >= 0
            ci_loc = torch.where(has, _take(qi, sel), n)
            w1_loc = torch.where(has, _take(w1, sel), 0.0)
            w2_loc = torch.where(has, _take(qw2, sel), 0.0)
            G = _all_gather(cg[:, :bc], cols_g, pr)
            I_ = _all_gather(ci_loc, cols_g, pr)
            W1 = _all_gather(w1_loc, cols_g, pr)
            W2 = _all_gather(w2_loc, cols_g, pr)
            g0, i0, (w1_0, w2_0) = _lex_pick(G, I_, [W1, W2], n)
            Cgain = _gather_n(g0, rows_g, pc, n)
            Ci = _gather_n(i0, rows_g, pc, n)
            Cw1 = _gather_n(w1_0, rows_g, pc, n)
            Cw2 = _gather_n(w2_0, rows_g, pc, n)
            Ci = torch.where(Cgain > NEG, Ci, n)
            return Cgain, Ci, Cw1, Cw2, aux

        zero = torch.zeros(2 if exchange_check else (), dtype=torch.int64,
                           device=dev)
        if backend in ("torch", "cuda"):
            # 1x1 grid: the block IS the instance; Steps A+B+C run through
            # the batched local sweep (the sweep kernel for "cuda")
            rptr = batched_row_ptr_from_sorted(brow, n)
            scratch = SweepScratch()

            def cwinners(state):  # noqa: F811 — the 1x1 override
                out = batch._cwinners_batched(
                    backend, brow, bcol, bval, rptr, n, state, mg,
                    window_steps, scratch)
                return (*out, zero)

        def mark(name, t0):
            if split is None:
                return t0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            split[name] = t1 - t0
            return t1

        t = time.perf_counter()
        if from_state:
            state0 = MatchState(*state_args)
        else:
            mr, mc = batch.greedy_loop(n, b, greedy_propose, dev)
            t = mark("greedy_s", t)
            mr, mc, _ = batch.mcm_loop(n, b, mr, mc, mcm_parents)
            t = mark("mcm_s", t)
            state0 = uv_state(mr, mc)
        state, iters, aux = batch.awac_loop(
            n, state0, max_iter, cwinners,
            active0=(batch.is_perfect_batched(state0, n)
                     if degrade_infeasible else None),
            aux0=zero)
        if not exchange_check:
            # the audit's pair is summed over ranks every round; the plain
            # dropped counter is summed once here
            dist.all_reduce(aux, group=spec.group)
        mark("awac_s", t)
        return state, iters, aux

    return run


def _widest_row(rows, n: int) -> int:
    """Most entries any row holds in any one block of any instance
    (at least 1). The blocks are lex-sorted, so a row's entries form one
    run: the longest run of equal (block, instance, row) keys."""
    rows = rows.reshape(-1, rows.shape[-1])
    offs = np.arange(rows.shape[0], dtype=np.int64)[:, None] * (n + 1)
    keys = (rows + offs)[rows < n]  # non-decreasing
    if keys.size == 0:
        return 1
    ends = np.flatnonzero(np.diff(keys)) + 1
    return int(np.diff(np.concatenate([[0], ends, [keys.size]])).max())


@dataclasses.dataclass
class _DistBatchedAWPM:
    """Host driver of the distributed-batched AWPM on this rank: plans the
    per-block capacity from the true block occupancy, partitions the
    padded [B, cap] batch over the grid, keeps this rank's block on its
    device, plans drop-free bucket capacities and runs the cached engine.
    The engine behind ``api.solve``/``plan`` on a grid."""

    spec: GridSpec
    n: int
    cap: int | None = None  # per-block capacity (None -> true occupancy)
    a2a_caps: tuple[int, int] | None = None  # None -> safe_a2a_caps
    max_iter: int = 1000
    min_gain: float = MIN_GAIN
    packed: bool = False
    backend: str = "fused"
    window_steps: int | None = None  # None -> measured from the partition
    degrade_infeasible: bool = False  # skip AWAC on infeasible instances
    exchange_check: bool = False  # per-round exchange conservation audit
    #: seconds of the last run's phases: partition, greedy, MCM, AWAC
    split: dict = dataclasses.field(default_factory=dict)

    def partition(self, row, col, val):
        """[B, cap] padded numpy COO -> (the partition, this rank's
        [B, cap_blk] block on the grid's device, the windowed-search depth
        measured over every block)."""
        spec = self.spec
        part = partition_coo_2d_batched(row, col, val, self.n, spec.pr,
                                        spec.pc, cap=self.cap)
        blocks = tuple(torch.from_numpy(x[spec.a, spec.b]).to(spec.device)
                       for x in (part.row, part.col, part.val))
        return part, blocks, window_depth(_widest_row(part.row, self.n))

    def run(self, row, col, val, state: MatchState | None = None):
        """row/col/val: padded [B, cap] lex-sorted numpy COO sharing n, the
        same on every rank. Returns (MatchState with [B, n + 1] fields,
        awac_iters [B], aux), per instance bit-identical to
        ``core.batch._awpm_batched(row, col, val, n)``. An explicit
        replicated ``state`` skips greedy and MCM and runs the AWAC phase
        only."""
        t0 = time.perf_counter()
        part, (brow, bcol, bval), ws = self.partition(row, col, val)
        self.split = {"partition_s": time.perf_counter() - t0}
        caps = self.a2a_caps or safe_a2a_caps(part.cap, self.spec.pr,
                                              self.spec.pc)
        if self.window_steps is not None:
            # a pin (plan()) keys one engine across calls; extra depth never
            # changes a search result, and it is clamped up to the measured
            # need so that it can never miss completion edges
            ws = max(ws, self.window_steps)
        fn = _make_awpm_dist_batched(
            self.spec, self.n, part.b, part.cap, caps, self.max_iter,
            self.min_gain, packed=self.packed, backend=self.backend,
            window_steps=ws, from_state=state is not None,
            degrade_infeasible=self.degrade_infeasible,
            exchange_check=self.exchange_check)
        if state is not None:
            return fn(brow, bcol, bval, *state, split=self.split)
        return fn(brow, bcol, bval, split=self.split)
