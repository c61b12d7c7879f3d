"""Batched AWPM engine: B instances of one n, solved together.

Row/col/val are padded [B, cap] COO (per-instance edge lists, padding
entries (n, n, 0)). Every phase runs on all instances at once with
per-instance convergence masks: a converged instance's state is frozen by
the mask while the rest of the batch keeps iterating.

Bit-exactness contract: for every instance b and every backend,
``_awpm_batched(row, col, val, n)`` produces exactly the arrays
``single._awpm(row[b], col[b], val[b], n)`` would. The greedy and MCM
round bodies here are ``single.greedy_round`` / ``single.mcm_phase``
re-expressed on the flat offset-segment primitives of ``sparse.ops``;
Step D and augmentation are ``single.select_and_augment`` itself. Extra
windowed-search depth (the batch measures one ``window_steps`` across all
instances) never changes a search result.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import single
from repro_torch.core.constants import MIN_GAIN
from repro_torch.core.single import F32, I32, NEG, MatchState
from repro_torch.kernels.cycle_gain.awac_sweep import SweepScratch
from repro_torch.kernels.cycle_gain.ops import (
    awac_persistent_loop_batched,
    awac_sweep_winners_batched,
)
from repro_torch.sparse.csr import batched_row_ptr_from_sorted
from repro_torch.sparse.ops import (
    batched_searchsorted_in_window,
    batched_segment_max_with_payload,
    batched_segment_min,
)


def stack_graphs(graphs, device=None):
    """Pad a list of BipartiteGraphs (shared n, arbitrary per-instance nnz)
    into batched [B, cap] (row, col, val) tensors with a common capacity.
    Extra slots are padding edges (n, n, 0), which every phase drops.
    ``device=None`` means the card."""
    device = single.resolve_device(device)
    n = graphs[0].n
    if any(g.n != n for g in graphs):
        raise ValueError("all instances in a batch must share n")
    cap = max(g.capacity for g in graphs)
    b = len(graphs)
    row = np.full((b, cap), n, np.int32)
    col = np.full((b, cap), n, np.int32)
    val = np.zeros((b, cap), np.float32)
    for i, g in enumerate(graphs):
        row[i, : g.capacity] = g.row
        col[i, : g.capacity] = g.col
        val[i, : g.capacity] = g.val
    return tuple(torch.from_numpy(x).to(device) for x in (row, col, val))


def empty_mates(b: int, n: int, device=None):
    device = single.resolve_device(device)
    full = torch.full((b, n + 1), n, dtype=I32, device=device)
    return full, full.clone()


def matching_weight_batched(state: MatchState, n: int) -> torch.Tensor:
    """Per-instance matching weight [B]."""
    return state.u[:, :n].sum(dim=1)


def is_perfect_batched(state: MatchState, n: int) -> torch.Tensor:
    """Per-instance perfect-matching flag [B]."""
    return (state.mate_row[:, :n] < n).all(dim=1)


def _take(x, idx):
    return x.gather(1, idx.long())


def state_from_mates_batched(row, col, val, n: int, mate_row,
                             mate_col) -> MatchState:
    """Batched ``single.state_from_mates``: fields are [B, n + 1]."""
    states = [single.state_from_mates(row[b], col[b], val[b], n, mate_row[b],
                                      mate_col[b])
              for b in range(row.shape[0])]
    return MatchState(*(torch.stack(f) for f in zip(*states)))


def _state_from_mates_windowed(row, col, val, row_ptr, n: int, mate_row,
                               mate_col, window_steps: int) -> MatchState:
    """``state_from_mates_batched`` with the matched-edge weight lookup as
    a CSR-windowed search inside each row's own segment. Identical output:
    (row i, mate_col[i]) is a unique key."""
    b, cap = row.shape
    mate_row = mate_row.to(I32)
    mate_col = mate_col.to(I32)
    pos, found = batched_searchsorted_in_window(
        col, mate_col[:, :n], row_ptr[:, :n], row_ptr[:, 1: n + 1],
        n_steps=window_steps)
    uu = torch.where(found, _take(val, pos.clamp(0, cap - 1)), 0.0)
    u = torch.zeros(b, n + 1, dtype=F32, device=row.device)
    u[:, :n] = uu
    v = torch.zeros(b, n + 1, dtype=F32, device=row.device)
    mr = mate_row[:, :n]
    v[:, :n] = torch.where(mr < n, _take(u, mr.clamp(0, n)), 0.0)
    return MatchState(mate_row, mate_col, u, v)


# --------------------------------------------------------------------------
# Phase 1: batched greedy weighted maximal matching
# --------------------------------------------------------------------------


def _ivec(b: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device).expand(b, n)


def greedy_propose_full(row, col, val, n: int, mate_row, mate_col):
    """Per-column best available proposal from the full batched edge list:
    (pv [B, n] score, NEG where none; prow [B, n] proposing row, sentinel
    n)."""
    b, cap = row.shape
    eidx = _ivec(b, cap, row.device)
    avail = (row < n) & (_take(mate_col, row) == n) & (_take(mate_row, col) == n)
    score = torch.where(avail, val, NEG)
    seg = torch.where(avail, col, n)
    pg, pe = batched_segment_max_with_payload(score, eidx, seg, n + 1)
    has = pe[:, :n] >= 0
    prow = torch.where(has, _take(row, pe[:, :n].clamp(min=0)), n)
    pv = torch.where(has, pg[:, :n], NEG)
    return pv, prow


def greedy_commit(pv, prow, n: int, mate_row, mate_col, active):
    """Per-row contest + mate scatter of one greedy proposal round. Frozen
    instances accept nothing. Returns (mate_row, mate_col, active)."""
    b = pv.shape[0]
    jvec = _ivec(b, n, pv.device)
    bidx = torch.arange(b, device=pv.device)[:, None]
    _, rj = batched_segment_max_with_payload(pv, jvec, prow, n + 1)
    ok = (rj[:, :n] >= 0) & active[:, None]
    wcol = torch.where(ok, rj[:, :n], n)
    mate_col = mate_col.clone()
    mate_row = mate_row.clone()
    mate_col[bidx, torch.where(ok, jvec, n).long()] = wcol
    mate_row[bidx, wcol.long()] = torch.where(ok, jvec, n)
    mate_col[:, n] = n
    mate_row[:, n] = n
    return mate_row, mate_col, active & ok.any(dim=1)


def greedy_loop(n: int, b: int, propose_fn, device):
    """Greedy proposal rounds for B instances with per-instance convergence
    masks. ``propose_fn(mate_row, mate_col) -> (pv, prow)`` supplies each
    round's per-column proposals: the full edge list here, 2D blocks and
    collectives in ``core.dist``. Instances whose round proposes nothing go
    inactive (their mates freeze). Returns (mate_row, mate_col), each
    [B, n + 1]."""
    mate_row, mate_col = empty_mates(b, n, device)
    active = torch.ones(b, dtype=torch.bool, device=device)
    while bool(active.any()):
        pv, prow = propose_fn(mate_row, mate_col)
        mate_row, mate_col, active = greedy_commit(pv, prow, n, mate_row,
                                                   mate_col, active)
    return mate_row, mate_col


def greedy_maximal_batched(row, col, val, n: int):
    """``single.greedy_maximal``'s proposal rounds for all instances at
    once (``greedy_loop`` over the full edge list). Returns (mate_row,
    mate_col), each [B, n + 1]."""
    return greedy_loop(
        n, row.shape[0],
        lambda mr, mc: greedy_propose_full(row, col, val, n, mr, mc),
        row.device)


# --------------------------------------------------------------------------
# Phase 2: batched maximum cardinality matching
# --------------------------------------------------------------------------


def bfs_parents_full(row, col, val, n: int, frontier, visited):
    """Per-row BFS parent proposals (new [B, n] mask, pcol [B, n] — valid
    only where ``new``) from the full batched edge list."""
    b, cap = row.shape
    eidx = _ivec(b, cap, row.device)
    elig = (row < n) & _take(frontier, col) & (~_take(visited, row))
    score = torch.where(elig, val, NEG)
    seg = torch.where(elig, row, n)
    _, re = batched_segment_max_with_payload(score, eidx, seg, n + 1)
    new = re[:, :n] >= 0
    pcol = _take(col, re[:, :n].clamp(min=0))
    return new, pcol


def bfs_commit(new, pcol, n: int, mate_col, parent_col, visited):
    """One BFS layer's state update. Returns (parent_col, visited,
    frontier, found)."""
    b = new.shape[0]
    bidx = torch.arange(b, device=new.device)[:, None]
    parent_col = parent_col.clone()
    parent_col[:, :n] = torch.where(new, pcol, parent_col[:, :n])
    visited = visited.clone()
    visited[:, :n] |= new
    free_new = new & (mate_col[:, :n] == n)
    found = free_new.any(dim=1)
    nf_idx = torch.where(new & ~free_new, mate_col[:, :n], n)
    frontier = torch.zeros(b, n + 1, dtype=torch.bool, device=new.device)
    frontier[bidx, nf_idx.long()] = True
    frontier[:, n] = False
    return parent_col, visited, frontier, found


def mcm_bfs_loop(n: int, b: int, mate_row, mate_col, parents_fn):
    """Layered BFS for all instances at once: per-instance layer counts,
    found flags and progress masks. ``parents_fn(frontier, visited) ->
    (new, pcol)`` supplies each layer's per-row parent winners (the full
    edge list here; 2D blocks and collectives in ``core.dist``). An
    instance whose own BFS terminated (found / stalled / layer bound)
    freezes while deeper searches continue. Returns (parent_col, visited,
    found, layers)."""
    dev = mate_row.device
    frontier = torch.zeros(b, n + 1, dtype=torch.bool, device=dev)
    frontier[:, :n] = mate_row[:, :n] == n
    parent_col = torch.full((b, n + 1), n, dtype=I32, device=dev)
    visited = torch.zeros(b, n + 1, dtype=torch.bool, device=dev)
    found = torch.zeros(b, dtype=torch.bool, device=dev)
    layers = torch.zeros(b, dtype=I32, device=dev)
    progressed = torch.ones(b, dtype=torch.bool, device=dev)

    def act_of():
        return (~found) & progressed & (layers <= n)

    act = act_of()
    while bool(act.any()):
        new, pcol = parents_fn(frontier, visited)
        parent_col2, visited2, frontier2, found2 = bfs_commit(
            new, pcol, n, mate_col, parent_col, visited)
        keep = act[:, None]
        frontier = torch.where(keep, frontier2, frontier)
        parent_col = torch.where(keep, parent_col2, parent_col)
        visited = torch.where(keep, visited2, visited)
        found = torch.where(act, found2, found)
        layers = layers + act.to(I32)
        progressed = torch.where(act, new.any(dim=1), progressed)
        act = act_of()
    return parent_col, visited, found, layers


def _mcm_bfs_batched(row, col, val, n: int, mate_row, mate_col):
    """``single._mcm_bfs`` for all instances at once (``mcm_bfs_loop``
    over the full edge list)."""
    return mcm_bfs_loop(
        n, row.shape[0], mate_row, mate_col,
        lambda fr, vis: bfs_parents_full(row, col, val, n, fr, vis))


def trace_and_flip_batched(parent_col, visited, found, layers, mate_row,
                           mate_col, n: int):
    """Batched ``single.trace_and_flip``: lockstep backtrace with
    per-column claims then flips, each instance running to its own
    ``layers`` bound under a per-instance mask."""
    b = parent_col.shape[0]
    dev = parent_col.device
    widx = _ivec(b, n + 1, dev)
    bidx = torch.arange(b, device=dev)[:, None]
    active = torch.zeros(b, n + 1, dtype=torch.bool, device=dev)
    active[:, :n] = visited[:, :n] & (mate_col[:, :n] == n)
    active &= found[:, None]
    steps = int(layers.max()) if b else 0

    cur = widx
    for t in range(steps):
        keep = (t < layers)[:, None]
        j_w = torch.where(active, _take(parent_col, cur), n)
        win = batched_segment_min(widx, j_w, n + 1, live=active)
        active2 = active & (_take(win, j_w) == widx)
        nxt = _take(mate_row, j_w)
        cur2 = torch.where(active2 & (nxt < n), nxt, cur)
        active = torch.where(keep, active2, active)
        cur = torch.where(keep, cur2, cur)

    surv, cur = active, widx
    for t in range(steps):
        keep = (t < layers)[:, None]
        j = torch.where(surv, _take(parent_col, cur), n)
        prev = _take(mate_row, j)
        mr2 = mate_row.clone()
        mr2[bidx, j.long()] = torch.where(surv, cur, prev)
        mc2 = mate_col.clone()
        mc2[bidx, torch.where(surv, cur, n).long()] = j
        mr2[:, n] = n
        mc2[:, n] = n
        surv2 = surv & (prev < n)
        cur2 = torch.where(surv2, prev, cur)
        surv = torch.where(keep, surv2, surv)
        cur = torch.where(keep, cur2, cur)
        mate_row = torch.where(keep, mr2, mate_row)
        mate_col = torch.where(keep, mc2, mate_col)
    return mate_row, mate_col


def mcm_loop(n: int, b: int, mate_row, mate_col, parents_fn):
    """Masked MCM phase loop over the batched BFS + trace/flip bodies,
    parameterized by the per-layer parent selection (``parents_fn``, see
    ``mcm_bfs_loop``), so the distributed engine shares every mask and
    commit. Returns (mate_row, mate_col, phases run)."""
    active = (mate_row[:, :n] == n).any(dim=1)
    phases = 0
    while bool(active.any()):
        phases += 1
        parent_col, visited, found, layers = mcm_bfs_loop(
            n, b, mate_row, mate_col, parents_fn)
        # frozen instances trace nothing: zero their layer counts + found
        found = found & active
        layers = torch.where(active, layers, 0)
        mr2, mc2 = trace_and_flip_batched(parent_col, visited, found, layers,
                                          mate_row, mate_col, n)
        keep = active[:, None]
        mate_row = torch.where(keep, mr2, mate_row)
        mate_col = torch.where(keep, mc2, mate_col)
        active = active & found & (mate_row[:, :n] == n).any(dim=1)
    return mate_row, mate_col, phases


def mcm_batched(row, col, val, n: int, mate_row, mate_col):
    """Batched MCM: ``mcm_loop`` over the full edge list. Returns
    (mate_row, mate_col)."""
    mate_row, mate_col, _ = mcm_loop(
        n, row.shape[0], mate_row, mate_col,
        lambda fr, vis: bfs_parents_full(row, col, val, n, fr, vis))
    return mate_row, mate_col


# --------------------------------------------------------------------------
# Phase 3: batched AWAC
# --------------------------------------------------------------------------


def awac_cwinners_fused_batched(row, col, val, row_ptr, n: int,
                                state: MatchState, min_gain,
                                window_steps: int):
    """Flat batched Steps A+B+C: the [B, cap] edge streams are one B * cap
    edge list with per-instance offset windows and offset segments,
    bit-identical per instance to ``single.awac_cwinners_fused``."""
    mate_row, mate_col, u, v = state
    b, cap = row.shape
    qr = _take(mate_row, col)  # m_j for each edge
    qc = _take(mate_col, row)  # m_i for each edge
    qr_s = qr.clamp(0, n)
    lo = _take(row_ptr, qr_s)
    hi = torch.where(qr < n, _take(row_ptr, qr_s + 1), lo)
    pos, found = batched_searchsorted_in_window(col, qc, lo, hi,
                                                n_steps=window_steps)
    w2 = torch.where(found, _take(val, pos.clamp(0, cap - 1)), 0.0)
    gain = val + w2 - _take(u, row) - _take(v, col)
    cand = found & (row < n) & (row > qr) & (gain > min_gain)
    eidx = _ivec(b, cap, row.device)
    seg = torch.where(cand, col, n)
    gm = torch.where(cand, gain, NEG)
    Cgain_full, Cedge = batched_segment_max_with_payload(gm, eidx, seg, n + 1)
    Cgain, Cedge = Cgain_full[:, :n], Cedge[:, :n]
    ce = Cedge.clamp(min=0)
    has = Cedge >= 0
    Ci = torch.where(has, _take(row, ce), n)
    Cw1 = torch.where(has, _take(val, ce), 0.0)
    Cw2 = torch.where(has, _take(w2, ce), 0.0)
    return Cgain, Ci, Cw1, Cw2


def _cwinners_batched(backend, row, col, val, row_ptr, n, state, min_gain,
                      window_steps, scratch=None):
    if backend == "reference":
        per = [single.awac_cwinners(row[b], col[b], val[b], n,
                                    MatchState(*(x[b] for x in state)),
                                    min_gain)
               for b in range(row.shape[0])]
        return tuple(torch.stack(f) for f in zip(*per))
    if backend == "torch":
        return awac_cwinners_fused_batched(row, col, val, row_ptr, n, state,
                                           min_gain, window_steps)
    if backend == "cuda":
        return awac_sweep_winners_batched(
            row, col, val, row_ptr, state.mate_row, state.mate_col, state.u,
            state.v, min_gain, n=n, window_steps=window_steps,
            scratch=scratch)
    raise ValueError(f"unknown AWAC backend {backend!r}")


# Convergence-mask hook for a fault-injection harness
# (``runtime.chaos``): when set, called as ``tap(active, iters) -> active``
# after each round's convergence update. None in production. The
# persistent kernel's loop ("cuda_persistent") runs inside the kernel and
# the single-instance loop (``single._awac_loop``) is its own: neither
# passes through here.
_CONVERGENCE_TAP = None


def awac_loop(n: int, state: MatchState, max_iter: int, cwinners_fn,
              active0=None, aux0=0):
    """Masked batched AWAC loop. ``cwinners_fn(state) -> (Cgain, Ci, Cw1,
    Cw2, aux)`` supplies each round's Step A+B+C winners and a value
    summed over the rounds (0 for the local backends; the distributed
    engine's dropped-candidate count, or its [dropped, integrity] pair
    under the exchange check). Step D + augmentation is
    ``single.select_and_augment``. ``active0`` ([B] bool) masks instances
    out from round 0 (the infeasible-instance short-circuit); ``aux0`` is
    the sum's start. Returns (state, iters [B], aux)."""
    b = state.mate_row.shape[0]
    dev = state.mate_row.device
    active = torch.full((b,), max_iter > 0, dtype=torch.bool, device=dev)
    if active0 is not None:
        active = active & active0
    iters = torch.zeros(b, dtype=I32, device=dev)
    aux = aux0
    # on the meta device (the dry run's trace) no flag can be read: one
    # round runs, the branch of a round that augments
    meta, rounds = dev.type == "meta", 0
    while (rounds < 1) if meta else bool(active.any()):
        rounds += 1
        Cgain, Ci, Cw1, Cw2, a = cwinners_fn(state)
        new_state, n_surv = single.select_and_augment(n, Cgain, Ci, Cw1, Cw2,
                                                      state)
        keep = active[:, None]
        state = MatchState(*(torch.where(keep, ns, s)
                             for ns, s in zip(new_state, state)))
        iters = iters + active.to(I32)
        active = active & (n_surv > 0) & (iters < max_iter)
        if _CONVERGENCE_TAP is not None:
            active = _CONVERGENCE_TAP(active, iters)
        aux = aux + a
    return state, iters, aux


def _resolve_window_steps_batched(row, n: int, window_steps) -> int:
    """``single._resolve_window_steps`` over [B, cap] rows: one depth for
    the whole batch (each instance's rows counted on their own; extra
    depth never changes a search result)."""
    return single._resolve_window_steps(row, n, window_steps)


def awac_batched(row, col, val, n: int, state: MatchState,
                 max_iter: int = 1000, min_gain: float = MIN_GAIN,
                 backend: str = "auto", row_ptr=None,
                 window_steps: int | None = None,
                 degrade_infeasible: bool = False):
    """Batched AWAC over [B, cap] instances. Returns (state, iters [B]).

    Same backend contract as ``single.awac``; every instance's result and
    iteration count are bit-identical to its own single-instance run."""
    backend = single.resolve_backend(backend, row.device, n=n,
                                     batch=row.shape[0])
    window_steps = _resolve_window_steps_batched(row, n, window_steps)
    if row_ptr is None:
        row_ptr = batched_row_ptr_from_sorted(row, n)
    min_gain = single._min_gain_tensor(min_gain, row.device)
    b = row.shape[0]
    active0 = is_perfect_batched(state, n) if degrade_infeasible else None
    if backend == "cuda_persistent":
        go0 = active0 if active0 is not None \
            else torch.ones(b, dtype=torch.bool, device=row.device)
        mr, mc, u, v, iters = awac_persistent_loop_batched(
            row, col, val, row_ptr, state.mate_row, state.mate_col, state.u,
            state.v, min_gain, go0, n=n, window_steps=window_steps,
            max_iter=max_iter)
        return MatchState(mr, mc, u, v), iters

    scratch = SweepScratch()  # the sweep kernel's, kept across rounds

    def cwinners(st):
        return (*_cwinners_batched(backend, row, col, val, row_ptr, n, st,
                                   min_gain, window_steps, scratch), 0)

    state, iters, _ = awac_loop(n, state, max_iter, cwinners,
                                active0=active0)
    return state, iters


# --------------------------------------------------------------------------
# Warm-start rematching: seed the pipeline from earlier mate arrays
# --------------------------------------------------------------------------


def _normalize_mates_batched(mate_row, mate_col, b: int, n: int, device):
    """Seed mates of shape [B, n] or [B, n + 1] (numpy or a tensor of any
    int dtype, on any device) as int32 [B, n + 1] tensors on ``device``
    with the sentinel slot pinned. A shape that cannot belong to the
    problem raises ValueError: the caller decides whether that means "fall
    back to cold" (serving) or "user error" (the facade)."""
    mate_row = torch.as_tensor(mate_row).to(device=device, dtype=I32)
    mate_col = torch.as_tensor(mate_col).to(device=device, dtype=I32)
    if mate_row.shape != mate_col.shape:
        raise ValueError(
            f"warm-start mate arrays disagree: mate_row "
            f"{tuple(mate_row.shape)} vs mate_col {tuple(mate_col.shape)}")
    if tuple(mate_row.shape) == (b, n):
        pad = torch.full((b, 1), n, dtype=I32, device=device)
        mate_row = torch.cat([mate_row, pad], dim=1)
        mate_col = torch.cat([mate_col, pad], dim=1)
    elif tuple(mate_row.shape) == (b, n + 1):
        mate_row, mate_col = mate_row.clone(), mate_col.clone()
    else:
        raise ValueError(
            f"warm-start mate arrays must be [B, n] or [B, n + 1] = "
            f"[{b}, {n + 1}], got {tuple(mate_row.shape)}")
    mate_row[:, n] = n
    mate_col[:, n] = n
    return mate_row, mate_col


def repair_mates_batched(row, col, val, row_ptr, n: int, mate_row, mate_col,
                         window_steps: int):
    """Repair seed mates against the current edge lists: a claimed pair
    (i, j) survives only if it is mutual (``mate_col[i] == j``) and the
    edge still exists (a membership probe through row i's CSR window). Any
    out-of-range, one-sided or stale entry is unmatched on both sides, so
    the output is a partial matching on existing edges whatever the seed
    held. Returns (mate_row, mate_col), int32 [B, n + 1]."""
    b = row.shape[0]
    dev = row.device
    jvec = _ivec(b, n, dev)
    mr = mate_row[:, :n]
    valid = (mr >= 0) & (mr < n)
    i_s = mr.clamp(0, n)
    lo = _take(row_ptr, i_s)
    hi = torch.where(valid, _take(row_ptr, i_s + 1), lo)
    _, found = batched_searchsorted_in_window(col, jvec, lo, hi,
                                              n_steps=window_steps)
    keep = valid & (_take(mate_col, i_s) == jvec) & found
    bidx = torch.arange(b, device=dev)[:, None]
    new_mr = torch.full((b, n + 1), n, dtype=I32, device=dev)
    new_mr[:, :n] = torch.where(keep, mr, n)
    new_mc = torch.full((b, n + 1), n, dtype=I32, device=dev)
    # kept pairs are mutual, so their rows are distinct; every dropped pair
    # writes n into slot n, and the sentinel is written last, after them
    new_mc[bidx, torch.where(keep, i_s, n).long()] = torch.where(keep, jvec,
                                                                 n)
    new_mr[:, n] = n
    new_mc[:, n] = n
    return new_mr, new_mc


def warm_mates_batched(row, col, val, row_ptr, n: int, mate_row, mate_col,
                       window_steps: int):
    """The repaired seed topped up by the pipeline's own batched MCM: the
    warm-start replacement for the cold greedy and MCM phases. Each MCM
    phase matches a free row or stops, so an intact seed runs none.
    Returns (mate_row, mate_col)."""
    mate_row, mate_col = repair_mates_batched(
        row, col, val, row_ptr, n, mate_row, mate_col, window_steps)
    return mcm_batched(row, col, val, n, mate_row, mate_col)


def _warm_state_batched(row, col, val, n: int, mate_row, mate_col, row_ptr,
                        window_steps: int) -> MatchState:
    """The warm engine's phases before AWAC: the seed normalized, repaired
    and topped up, then its duals built. The grid runs its AWAC from this
    state. Returns a MatchState of [B, n + 1] fields."""
    mate_row, mate_col = _normalize_mates_batched(
        mate_row, mate_col, row.shape[0], n, row.device)
    mate_row, mate_col = warm_mates_batched(
        row, col, val, row_ptr, n, mate_row, mate_col, window_steps)
    return _state_from_mates_windowed(row, col, val, row_ptr, n, mate_row,
                                      mate_col, window_steps)


def _awpm_batched_from_state(row, col, val, n: int, mate_row, mate_col,
                             max_iter: int = 1000,
                             min_gain: float = MIN_GAIN,
                             backend: str = "auto", row_ptr=None,
                             window_steps: int | None = None,
                             degrade_infeasible: bool = False):
    """Warm-start batched pipeline: repair the seed mates -> MCM top-up ->
    AWAC, in place of greedy and MCM from scratch. Returns (MatchState,
    awac_iters [B]), the contract of ``_awpm_batched``.

    A seed that is an AWAC fixed point of the same instance (the earlier
    result of an unchanged problem) keeps every pair, the top-up runs no
    phase and AWAC stops after its first round: the seed matching comes
    back bit-identical, mates, duals and weight."""
    window_steps = _resolve_window_steps_batched(row, n, window_steps)
    if row_ptr is None:
        row_ptr = batched_row_ptr_from_sorted(row, n)
    state = _warm_state_batched(row, col, val, n, mate_row, mate_col,
                                row_ptr, window_steps)
    return awac_batched(row, col, val, n, state, max_iter=max_iter,
                        min_gain=min_gain, backend=backend, row_ptr=row_ptr,
                        window_steps=window_steps,
                        degrade_infeasible=degrade_infeasible)


def _awpm_batched(row, col, val, n: int, max_iter: int = 1000,
                  min_gain: float = MIN_GAIN, backend: str = "auto",
                  row_ptr=None, window_steps: int | None = None,
                  degrade_infeasible: bool = False):
    """Full batched pipeline: greedy maximal -> MCM -> AWAC for B
    instances. Returns (MatchState with [B, n + 1] fields, awac_iters [B]),
    per instance bit-identical to ``single._awpm`` on the same backend.
    The batched engine behind ``api.solve``."""
    window_steps = _resolve_window_steps_batched(row, n, window_steps)
    if row_ptr is None:
        row_ptr = batched_row_ptr_from_sorted(row, n)
    mate_row, mate_col = greedy_maximal_batched(row, col, val, n)
    mate_row, mate_col = mcm_batched(row, col, val, n, mate_row, mate_col)
    state = _state_from_mates_windowed(row, col, val, row_ptr, n, mate_row,
                                       mate_col, window_steps)
    return awac_batched(row, col, val, n, state, max_iter=max_iter,
                        min_gain=min_gain, backend=backend, row_ptr=row_ptr,
                        window_steps=window_steps,
                        degrade_infeasible=degrade_infeasible)
