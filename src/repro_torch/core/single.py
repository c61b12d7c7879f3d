"""Single-instance AWPM on torch tensors: greedy maximal -> MCM -> AWAC.

Conventions (everywhere in repro_torch.core):
  - square matrix, n rows == n cols; edges as padded COO sorted lex by
    (row, col) with padding entries (n, n, 0); row/col int32, val float32.
  - ``mate_row`` [n+1]: row matched to column j (sentinel n = unmatched;
    slot n is always n). ``mate_col`` [n+1]: column matched to row i.
  - ``u`` [n+1]: weight of row i's matched edge; ``v`` [n+1]: weight of
    column j's matched edge. Slot n is 0.
  - all weights float32; gains computed as ``w1 + w2 - u - v`` in that
    order so every backend agrees bit for bit.

The loops of the phases are Python loops that read one flag from the
device per round; ``repro_torch.obs`` spans each phase, each greedy round
and BFS layer, and each such read (``d2h.<site>``). On the card, with a
kernel backend, MCM runs in one kernel launch instead
(``kernels.mcm.persistent``), read once. Scatters with
duplicate indices only ever write values that are identical across the
duplicates (the dump slot ``n``, reset afterwards), and every winner
selection is an order-free max/min, so the results do not depend on the
order in which the device combines writes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.constants import MIN_GAIN
from repro_torch.kernels.cycle_gain.awac_sweep import SweepScratch
from repro_torch.kernels.cycle_gain.ops import awac_persistent_loop, awac_sweep_winners
from repro_torch.kernels.dispatch import choose_backend
from repro_torch.kernels.mcm.persistent import mcm_persistent
from repro_torch.sparse.csr import max_row_nnz, row_ptr_from_sorted, window_depth
from repro_torch.sparse.ops import (
    NEG,
    batched_segment_max_with_payload,
    lex_searchsorted,
    searchsorted_in_window,
    segment_max_with_payload,
    segment_min,
)

I32 = torch.int32
F32 = torch.float32

#: every concrete local AWAC backend; "auto" resolves to one of them
LOCAL_BACKENDS = ("reference", "torch", "cuda", "cuda_persistent")
#: backends that launch a hand-written kernel for a problem on the card
KERNEL_BACKENDS = ("cuda", "cuda_persistent")


class MatchState(NamedTuple):
    mate_row: torch.Tensor  # [n+1] int32 (or [B, n+1])
    mate_col: torch.Tensor  # [n+1] int32
    u: torch.Tensor  # [n+1] float32
    v: torch.Tensor  # [n+1] float32


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def resolve_device(device=None) -> torch.device:
    """The device a public constructor builds on: ``None`` means the card.
    Raises when a CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build on "
            "the CPU")
    return dev


def empty_state(n: int, device=None) -> MatchState:
    device = resolve_device(device)
    return MatchState(
        torch.full((n + 1,), n, dtype=I32, device=device),
        torch.full((n + 1,), n, dtype=I32, device=device),
        torch.zeros(n + 1, dtype=F32, device=device),
        torch.zeros(n + 1, dtype=F32, device=device),
    )


def _with_sentinel(mates: torch.Tensor, n: int) -> torch.Tensor:
    if mates.shape[-1] == n:
        pad = torch.full((*mates.shape[:-1], 1), n, dtype=I32,
                         device=mates.device)
        mates = torch.cat([mates, pad], dim=-1)
    return mates


def state_from_mates(row, col, val, n: int, mate_row, mate_col) -> MatchState:
    """Build MatchState (incl. u, v) from mate arrays (len n or n+1)."""
    dev = row.device
    mate_row = _with_sentinel(torch.as_tensor(mate_row, dtype=I32, device=dev), n)
    mate_col = _with_sentinel(torch.as_tensor(mate_col, dtype=I32, device=dev), n)
    cap = row.shape[0]
    pos, found = lex_searchsorted(row, col, _arange(n, dev), mate_col[:n])
    uu = torch.where(found, val[pos.clamp(0, cap - 1).long()], 0.0)
    u = torch.zeros(n + 1, dtype=F32, device=dev)
    u[:n] = uu
    v = torch.zeros(n + 1, dtype=F32, device=dev)
    mr = mate_row[:n]
    v[:n] = torch.where(mr < n, u[mr.long()], 0.0)
    return MatchState(mate_row, mate_col, u, v)


def matching_weight(state: MatchState, n: int) -> torch.Tensor:
    return state.u[:n].sum()


def is_perfect(state: MatchState, n: int) -> torch.Tensor:
    return (state.mate_row[:n] < n).all()


# --------------------------------------------------------------------------
# Phase 1: greedy weighted maximal matching (proposal rounds)
# --------------------------------------------------------------------------


def greedy_round(row, col, val, n: int, mate_row, mate_col):
    """One proposal round of the greedy weighted maximal matching: every
    column proposes to its heaviest available row, every row accepts its
    best proposal. Returns (mate_row, mate_col, progressed)."""
    dev = row.device
    cap = row.shape[0]
    eidx = _arange(cap, dev)
    jvec = _arange(n, dev)
    avail = (row < n) & (mate_col[row.long()] == n) & (mate_row[col.long()] == n)
    score = torch.where(avail, val, NEG)
    seg = torch.where(avail, col, n)
    pg, pe = segment_max_with_payload(score, eidx, seg, n + 1)
    has = pe[:n] >= 0
    prow = torch.where(has, row[pe[:n].clamp(min=0).long()], n)
    pv = torch.where(has, pg[:n], NEG)
    _, rj = segment_max_with_payload(pv, jvec, prow, n + 1)
    ok = rj[:n] >= 0  # per-row winning proposal col
    wcol = torch.where(ok, rj[:n], n)
    mate_col = mate_col.clone()
    mate_row = mate_row.clone()
    # rows that won nothing, and columns nobody won, write n into slot n
    mate_col[torch.where(ok, jvec, n).long()] = wcol
    mate_row[wcol.long()] = torch.where(ok, jvec, n)
    mate_col[n] = n
    mate_row[n] = n
    return mate_row, mate_col, ok.any()


def greedy_maximal(row, col, val, n: int) -> MatchState:
    with obs.span("greedy"):
        st = empty_state(n, row.device)
        mate_row, mate_col = st.mate_row, st.mate_col
        progressed = True
        while progressed:
            with obs.step("greedy.round"):
                obs.count("greedy.rounds")
                mate_row, mate_col, progressed = greedy_round(
                    row, col, val, n, mate_row, mate_col)
                progressed = obs.flag(progressed, "greedy")
        return state_from_mates(row, col, val, n, mate_row, mate_col)


# --------------------------------------------------------------------------
# Phase 2: maximum cardinality matching (layered BFS + lockstep trace/flip)
# --------------------------------------------------------------------------


def trace_and_flip(parent_col, visited, found, layers: int, mate_row,
                   mate_col, n: int):
    """Lockstep backtrace with per-column claims (winner = smallest endpoint
    row id), then flip the surviving vertex-disjoint augmenting paths.

    All augmenting paths from one layered BFS have the same number of
    column steps (``layers``) and every column belongs to exactly one BFS
    layer, so one claim round per step suffices."""
    dev = parent_col.device
    widx = _arange(n + 1, dev)  # walker ids (= endpoint row ids)
    active = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    active[:n] = visited[:n] & (mate_col[:n] == n)
    active &= bool(found)
    cur = widx
    for _ in range(layers):
        j_w = torch.where(active, parent_col[cur.long()], n)
        win = segment_min(widx, j_w, n + 1, live=active)
        active = active & (win[j_w.long()] == widx)
        nxt = mate_row[j_w.long()]
        cur = torch.where(active & (nxt < n), nxt, cur)

    surv, cur = active, widx
    for _ in range(layers):
        j = torch.where(surv, parent_col[cur.long()], n).long()
        prev = mate_row[j]
        mate_row = mate_row.clone()
        mate_col = mate_col.clone()
        mate_row[j] = torch.where(surv, cur, prev)
        mate_col[torch.where(surv, cur, n).long()] = j.to(I32)
        mate_row[n] = n
        mate_col[n] = n
        surv = surv & (prev < n)
        cur = torch.where(surv, prev, cur)
    return mate_row, mate_col


def _mcm_bfs(row, col, val, n: int, mate_row, mate_col):
    """One layered BFS from all free rows with weight-aware parent
    selection. Returns (parent_col, visited, found, layers)."""
    dev = row.device
    cap = row.shape[0]
    eidx = _arange(cap, dev)
    rowl, coll = row.long(), col.long()
    frontier = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    frontier[:n] = mate_row[:n] == n
    parent_col = torch.full((n + 1,), n, dtype=I32, device=dev)
    visited = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    found, layers, progressed = False, 0, True
    while (not found) and progressed and layers <= n:
        with obs.step("mcm.layer"):
            obs.count("mcm.layers")
            elig = (row < n) & frontier[coll] & (~visited[rowl])
            score = torch.where(elig, val, NEG)
            seg = torch.where(elig, row, n)
            _, re = segment_max_with_payload(score, eidx, seg, n + 1)
            new = re[:n] >= 0
            pc = torch.where(new, col[re[:n].clamp(min=0).long()],
                             parent_col[:n])
            parent_col = parent_col.clone()
            parent_col[:n] = pc
            visited = visited.clone()
            visited[:n] |= new
            free_new = new & (mate_col[:n] == n)
            nf_idx = torch.where(new & ~free_new, mate_col[:n], n)
            frontier = torch.zeros(n + 1, dtype=torch.bool, device=dev)
            frontier[nf_idx.long()] = True
            frontier[n] = False
            layers += 1
            with obs.d2h("mcm_layer"):
                found, progressed = torch.stack(
                    [free_new.any(), new.any()]).tolist()
    return parent_col, visited, found, layers


def mcm_phase(row, col, val, n: int, mate_row, mate_col):
    """One MCM phase: layered BFS + trace/flip of the augmenting paths it
    found. Returns (mate_row, mate_col, found, BFS layers)."""
    parent_col, visited, found, layers = _mcm_bfs(row, col, val, n, mate_row,
                                                 mate_col)
    with obs.span("mcm.flip"):
        mate_row, mate_col = trace_and_flip(parent_col, visited, found,
                                            layers, mate_row, mate_col, n)
    return mate_row, mate_col, found, layers


def mcm_plain(row, col, val, n: int, mate_row, mate_col):
    """The MCM phases in plain torch, the MCM kernel's plain version: while
    a column is free and the last phase found a path. Returns (mate_row,
    mate_col, phases, BFS layers, whether a column is still free)."""
    phases = layers = 0
    while True:
        free = obs.flag((mate_row[:n] == n).any(), "mcm_phase")
        if not free:
            break
        obs.count("mcm.phases")
        mate_row, mate_col, found, k = mcm_phase(row, col, val, n, mate_row,
                                                 mate_col)
        phases += 1
        layers += k
        if not found:
            break
    return mate_row, mate_col, phases, layers, free


def _mcm_on_kernel(row, n: int, backend: str) -> bool:
    """Whether MCM runs in its kernel: a problem on the card with a kernel
    backend; the plain version everywhere else."""
    return row.device.type == "cuda" and \
        resolve_backend(backend, row.device, n=n) in KERNEL_BACKENDS


def mcm(row, col, val, n: int, mate_row, mate_col, backend: str = "auto",
        row_ptr=None) -> MatchState:
    """Maximum cardinality matching from an initial matching, with the
    paper's weight-aware tie-breaking (heaviest eligible edge chosen as BFS
    parent).

    backend: as ``awac``'s. On a CUDA tensor a kernel backend runs every
    phase in the MCM kernel, one launch and one read of its stats; any
    other backend or device runs the plain version (``mcm_plain``), one
    read per BFS layer. Both give identical mates, phases and layers.
    ``row_ptr`` (``row_ptr_from_sorted``) is the kernel's; made here when
    not given."""
    with obs.span("mcm"):
        obs.count("mcm.layers", 0)
        obs.count("mcm.phases", 0)
        mate_row = _with_sentinel(mate_row.to(I32), n)
        mate_col = _with_sentinel(mate_col.to(I32), n)
        if _mcm_on_kernel(row, n, backend):
            if row_ptr is None:
                row_ptr = row_ptr_from_sorted(row, n)
            mate_row, mate_col, stats = mcm_persistent(
                row, col, val, row_ptr, mate_row, mate_col, n=n)
            with obs.d2h("mcm"):
                phases, layers, _ = stats.tolist()
            obs.count("mcm.kernel")
            obs.count("mcm.phases", phases)
            obs.count("mcm.layers", layers)
        else:
            obs.count("mcm.kernel", 0)
            mate_row, mate_col, *_ = mcm_plain(row, col, val, n, mate_row,
                                               mate_col)
        return state_from_mates(row, col, val, n, mate_row, mate_col)


# --------------------------------------------------------------------------
# Phase 3: AWAC — approximate-weight augmenting 4-cycles
# --------------------------------------------------------------------------


def select_and_augment(n: int, Cgain, Ci, Cw1, Cw2, state: MatchState,
                       min_gain=None):
    """Steps D + survivor selection + augmentation, given the per-column
    Step-C winners. Works on one instance ([n] winners, [n+1] state) or a
    batch (leading B on everything); the batched engine shares this code.

    Cgain [n] f32 (-inf if column unrooted), Ci [n] winner row, Cw1/Cw2 [n]
    weights of the (i,j) and (m_j, m_i) edges of the winning cycle.
    Returns (new_state, n_survivors)."""
    single = Cgain.dim() == 1
    if single:
        Cgain, Ci, Cw1, Cw2 = (x[None] for x in (Cgain, Ci, Cw1, Cw2))
        state = MatchState(*(x[None] for x in state))
    mate_row, mate_col, u, v = state
    b = Cgain.shape[0]
    dev = Cgain.device
    bidx = torch.arange(b, device=dev)[:, None]
    jvec = _arange(n, dev).expand(b, n)
    rooted = Cgain > NEG
    Ci_s = Ci.clamp(0, n).long()
    e2 = torch.where(rooted, mate_col.gather(1, Ci_s), n)
    dgain = torch.where(rooted, Cgain, NEG)
    dg, dj = batched_segment_max_with_payload(dgain, jvec, e2, n + 1)
    surv_c2 = (dg[:, :n] > NEG) & (~rooted)  # e2-columns whose winner survives
    surv_root = torch.where(surv_c2, dj[:, :n], n).long()
    mask = torch.zeros(b, n + 1, dtype=torch.bool, device=dev)
    mask[bidx, surv_root] = True
    mask_j = mask[:, :n] & rooted
    n_surv = mask_j.sum(dim=1)

    # deterministic fallback: single globally-best cycle (paper: random
    # augmentation); argmax returns the first index of the maximum
    best_j = torch.argmax(torch.where(rooted, Cgain, NEG), dim=1)
    use_fb = (n_surv == 0) & rooted.any(dim=1)
    mask_j = mask_j | ((jvec == best_j[:, None]) & use_fb[:, None])
    n_surv = n_surv + use_fb.to(n_surv.dtype)

    # ---- augment all surviving cycles (vertex-disjoint by construction);
    # masked lanes all target slot n, which is reset at the end
    i_ = Ci_s.to(I32)
    r2 = mate_row[:, :n]  # old mate row of each column j
    c2 = mate_col.gather(1, Ci_s)  # old mate col of each winner row i
    mj = torch.where(mask_j, jvec, n).long()
    mi = torch.where(mask_j, i_, n).long()
    mr2 = torch.where(mask_j, r2, n).long()
    mc2 = torch.where(mask_j, c2, n).long()
    mate_row = mate_row.clone()
    mate_col = mate_col.clone()
    u = u.clone()
    v = v.clone()
    mate_row[bidx, mj] = torch.where(mask_j, i_, mate_row[bidx, mj])
    mate_row[bidx, mc2] = torch.where(mask_j, r2, mate_row[bidx, mc2])
    mate_col[bidx, mi] = torch.where(mask_j, jvec, mate_col[bidx, mi])
    mate_col[bidx, mr2] = torch.where(mask_j, c2, mate_col[bidx, mr2])
    u[bidx, mi] = torch.where(mask_j, Cw1, u[bidx, mi])
    u[bidx, mr2] = torch.where(mask_j, Cw2, u[bidx, mr2])
    v[bidx, mj] = torch.where(mask_j, Cw1, v[bidx, mj])
    v[bidx, mc2] = torch.where(mask_j, Cw2, v[bidx, mc2])
    mate_row[:, n] = n
    mate_col[:, n] = n
    u[:, n] = 0.0
    v[:, n] = 0.0
    new_state = MatchState(mate_row, mate_col, u, v)
    if single:
        return MatchState(*(x[0] for x in new_state)), n_surv[0]
    return new_state, n_surv


def awac_candidates(row, col, val, n: int, state: MatchState, min_gain):
    """Steps A+B on the full edge list: per-edge completion lookup (a
    global log2(m)-round lex search) + gain."""
    mate_row, mate_col, u, v = state
    rowl, coll = row.long(), col.long()
    qr = mate_row[coll]  # m_j for each edge's column
    qc = mate_col[rowl]  # m_i for each edge's row
    pos, found = lex_searchsorted(row, col, qr, qc)
    w2 = torch.where(found, val[pos.clamp(0, row.shape[0] - 1).long()], 0.0)
    gain = val + w2 - u[rowl] - v[coll]
    cand = found & (row < n) & (row > qr) & (gain > min_gain)
    return cand, gain, w2


def _winners_from_candidates(row, col, val, n, cand, gain, w2):
    """Step C: per-column winner (max gain, smallest edge index = smallest
    row on a tie) and its row and weights."""
    eidx = _arange(row.shape[0], row.device)
    seg = torch.where(cand, col, n)
    gm = torch.where(cand, gain, NEG)
    Cgain_full, Cedge = segment_max_with_payload(gm, eidx, seg, n + 1)
    Cgain, Cedge = Cgain_full[:n], Cedge[:n]
    ce = Cedge.clamp(min=0).long()
    has = Cedge >= 0
    Ci = torch.where(has, row[ce], n)
    Cw1 = torch.where(has, val[ce], 0.0)
    Cw2 = torch.where(has, w2[ce], 0.0)
    return Cgain, Ci, Cw1, Cw2


def awac_cwinners(row, col, val, n: int, state: MatchState, min_gain):
    """Step C on the full edge list: per-column winner (gain, i, w1, w2).
    The bit-exactness oracle, run by ``backend="reference"``."""
    cand, gain, w2 = awac_candidates(row, col, val, n, state, min_gain)
    return _winners_from_candidates(row, col, val, n, cand, gain, w2)


def awac_cwinners_fused(row, col, val, row_ptr, n: int, state: MatchState,
                        min_gain, window_steps: int):
    """Steps A+B+C with the completion lookup for (m_j, m_i) as a windowed
    binary search inside row m_j's CSR segment (``window_steps`` rounds).
    Bit-identical to ``awac_cwinners``; run by ``backend="torch"``."""
    mate_row, mate_col, u, v = state
    rowl, coll = row.long(), col.long()
    cap = row.shape[0]
    qr = mate_row[coll]
    qc = mate_col[rowl]
    qr_s = qr.clamp(0, n).long()
    lo = row_ptr[qr_s]
    # qr == n (unmatched column / padding edge) -> empty window
    hi = torch.where(qr < n, row_ptr[qr_s + 1], lo)
    pos, found = searchsorted_in_window(col, qc, lo, hi, n_steps=window_steps)
    w2 = torch.where(found, val[pos.clamp(0, cap - 1).long()], 0.0)
    gain = val + w2 - u[rowl] - v[coll]
    cand = found & (row < n) & (row > qr) & (gain > min_gain)
    return _winners_from_candidates(row, col, val, n, cand, gain, w2)


def _cwinners(backend, row, col, val, row_ptr, n, state, min_gain,
              window_steps, scratch=None):
    if backend == "reference":
        return awac_cwinners(row, col, val, n, state, min_gain)
    if backend == "torch":
        return awac_cwinners_fused(row, col, val, row_ptr, n, state, min_gain,
                                   window_steps)
    if backend == "cuda":
        return awac_sweep_winners(row, col, val, row_ptr, state.mate_row,
                                  state.mate_col, state.u, state.v, min_gain,
                                  n=n, window_steps=window_steps,
                                  scratch=scratch)
    raise ValueError(f"unknown AWAC backend {backend!r}")


def resolve_auto(device, n: int | None = None,
                 batch: int | None = None) -> tuple[str, str]:
    """Where "auto" goes for a problem of ``n`` vertices (a batch of
    ``batch`` instances) on ``device``, and why: (backend, "table") when
    the measured dispatch table (``kernels.dispatch``) has a winner for
    the device type and shape class, else (backend, "heuristic"): the
    persistent CUDA kernel on the card, the plain torch sweep on the CPU,
    a rule no measurement backs."""
    platform = torch.device(device).type
    winner = choose_backend(n=n, batch=batch, platform=platform)
    if winner is not None:
        return winner, "table"
    return ("cuda_persistent" if platform == "cuda" else "torch"), \
        "heuristic"


def resolve_backend(backend: str, device, n: int | None = None,
                    batch: int | None = None) -> str:
    """Resolve ``"auto"`` to a concrete local AWAC backend
    (:func:`resolve_auto`); any other name passes through, checked."""
    if backend != "auto":
        if backend not in LOCAL_BACKENDS:
            raise ValueError(f"unknown AWAC backend {backend!r}")
        return backend
    return resolve_auto(device, n=n, batch=batch)[0]


def _resolve_window_steps(row, n: int, window_steps) -> int:
    """Windowed-search depth: the measured need (one device read), or an
    override clamped up to it — extra depth never changes a search result,
    too little would miss completion edges."""
    cap = int(row.shape[-1])
    if window_steps is not None:
        ws = int(window_steps)
        # a row holds at most min(cap, n) entries: that depth always covers
        if ws >= window_depth(min(cap, n)):
            return ws
        return max(ws, window_depth(max_row_nnz(row, n)))
    return window_depth(max_row_nnz(row, n))


def _min_gain_tensor(min_gain, device) -> torch.Tensor:
    """``gain > min_gain`` compares in float32 on every path."""
    return torch.as_tensor(min_gain, dtype=F32, device=device)


def _awac_loop(row, col, val, row_ptr, n: int, state: MatchState,
               max_iter: int, min_gain, backend: str, window_steps: int,
               degrade_infeasible: bool = False):
    go = obs.flag(is_perfect(state, n), "awac") if degrade_infeasible \
        else True
    it = 0
    scratch = SweepScratch()  # the sweep kernel's, kept across rounds
    while go and it < max_iter:
        Cgain, Ci, Cw1, Cw2 = _cwinners(backend, row, col, val, row_ptr, n,
                                        state, min_gain, window_steps,
                                        scratch)
        state, n_surv = select_and_augment(n, Cgain, Ci, Cw1, Cw2, state)
        it += 1
        go = obs.flag(n_surv > 0, "awac")
    return state, torch.tensor(it, dtype=I32, device=row.device)


def awac(row, col, val, n: int, state: MatchState, max_iter: int = 1000,
         min_gain: float = MIN_GAIN, backend: str = "auto", row_ptr=None,
         window_steps: int | None = None, degrade_infeasible: bool = False):
    """Full AWAC loop. Returns (state, iters).

    backend: "auto" (see ``resolve_backend``) | "torch" (windowed sweep in
    plain torch) | "cuda" (the hand-written sweep kernel, one launch per
    round) | "cuda_persistent" (the whole loop in one kernel launch) |
    "reference" (global lex search, the bit-exactness oracle). On a CPU
    tensor the two kernel backends run their kernels' plain versions. All
    backends produce identical states and iteration counts.
    """
    with obs.span("awac"):
        backend = resolve_backend(backend, row.device, n=n)
        window_steps = _resolve_window_steps(row, n, window_steps)
        if row_ptr is None:
            row_ptr = row_ptr_from_sorted(row, n)
        min_gain = _min_gain_tensor(min_gain, row.device)
        if backend == "cuda_persistent":
            go0 = is_perfect(state, n) if degrade_infeasible \
                else torch.tensor(True, device=row.device)
            mr, mc, u, v, iters = awac_persistent_loop(
                row, col, val, row_ptr, state.mate_row, state.mate_col,
                state.u, state.v, min_gain, go0, n=n,
                window_steps=window_steps, max_iter=max_iter)
            return MatchState(mr, mc, u, v), iters
        return _awac_loop(row, col, val, row_ptr, n, state, max_iter,
                          min_gain, backend, window_steps, degrade_infeasible)


def _awpm(row, col, val, n: int, max_iter: int = 1000,
          min_gain: float = MIN_GAIN, backend: str = "auto",
          window_steps: int | None = None, degrade_infeasible: bool = False):
    """Full pipeline: greedy maximal -> MCM -> AWAC. Returns (state,
    awac_iters). The single-instance engine behind ``api.solve``."""
    row_ptr = row_ptr_from_sorted(row, n)
    st = greedy_maximal(row, col, val, n)
    st = mcm(row, col, val, n, st.mate_row, st.mate_col, backend=backend,
             row_ptr=row_ptr)
    return awac(row, col, val, n, st, max_iter=max_iter, min_gain=min_gain,
                backend=backend, row_ptr=row_ptr, window_steps=window_steps,
                degrade_infeasible=degrade_infeasible)
