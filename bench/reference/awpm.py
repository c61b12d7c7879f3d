"""Plain reference of the matching that the benchmark's cells time.

The paper's pipeline (Azad et al., IPDPS 2018) written out in plain
PyTorch, one instance at a time, with no kernels and nothing of the
program: a greedy weighted maximal matching, a maximum cardinality
matching by layered BFS with weight-aware parents, then AWAC, rounds of
vertex-disjoint augmenting 4-cycles until none gains more than
``MIN_GAIN``. The warm path repairs a seed matching against the edge
list, tops it up with the same MCM and runs AWAC from there.

The rules that make the answer unique, and that the program guarantees
(bit-identical mates and rounds on every backend):

- every winner is the largest value, the smallest index on a tie: a
  column's greedy proposal and a row's BFS parent by edge position
  (lex order of (row, col)), a row's accepted proposal by column, a
  column's 4-cycle by edge position, an e2 column's surviving cycle by
  root column, the fallback cycle by column;
- a gain is ``((w1 + w2) - u_i) - v_j``, each step rounded to ``dtype``,
  and counts where it exceeds ``MIN_GAIN`` in ``dtype``;
- the MCM backtrace claims each column for the smallest endpoint row.

Edges come as a lex-sorted padded pattern (padding rows and columns are
``n``); lookups go through the sorted keys ``row * (n + 1) + col``.
``dtype`` is float32 for the reference and bfloat16 for the control.
"""
from __future__ import annotations

import dataclasses

import torch

NEG = float("-inf")
BIG = 2**62
MIN_GAIN = 1e-6
MAX_ITER = 1000
I64 = torch.int64


@dataclasses.dataclass
class Answer:
    """One instance's matching: ``mate_row[j]`` is the row of column j,
    ``mate_col[i]`` the column of row i, [n + 1] int64 with ``n`` for
    unmatched and slot n pinned to n; ``u[i]`` the weight of row i's
    matched edge in ``dtype``; the AWAC rounds run."""

    mate_row: torch.Tensor
    mate_col: torch.Tensor
    u: torch.Tensor
    rounds: int

    def weight(self) -> float:
        """The matched weight, summed in float64."""
        return float(self.u[:-1].double().sum())

    def perfect(self) -> bool:
        n = self.mate_row.shape[0] - 1
        return bool((self.mate_row[:n] < n).all())


def argmax_by(values, payload, seg, nseg: int):
    """Per segment, the largest of ``values`` and the smallest ``payload``
    among the entries that reach it; (-inf, -1) for a segment with no
    entry above -inf."""
    top = torch.full((nseg,), NEG, dtype=values.dtype, device=values.device)
    top = top.scatter_reduce(0, seg, values, "amax", include_self=True)
    hit = (values > NEG) & (values == top[seg])
    pick = torch.full((nseg,), BIG, dtype=I64, device=values.device)
    pick = pick.scatter_reduce(0, seg, torch.where(hit, payload, BIG), "amin",
                               include_self=True)
    return top, torch.where(pick == BIG, -1, pick)


class Reference:
    """The pipeline over one fixed pattern (``row``, ``col``: lex-sorted,
    padded with ``n``), for values given per call."""

    def __init__(self, row, col, n: int, dtype=torch.float32):
        self.n = n
        self.dtype = dtype
        self.row = row.to(I64)
        self.col = col.to(I64)
        self.real = self.row < n
        self.keys = self.row * (n + 1) + self.col
        self.eidx = torch.arange(self.row.shape[0], device=row.device)
        self.jvec = torch.arange(n, device=row.device)
        # the edges column by column, for the BFS's frontier columns
        self.by_col = torch.argsort(self.col * (n + 1) + self.row)
        self.col_ptr = torch.zeros(n + 2, dtype=I64, device=row.device)
        self.col_ptr[1:] = torch.cumsum(torch.bincount(self.col,
                                                       minlength=n + 1), 0)

    # ---------------------------------------------------------------- helpers
    def find(self, r, c):
        """The position of edge (r, c) and whether it exists."""
        q = r * (self.n + 1) + c
        pos = torch.searchsorted(self.keys, q).clamp(max=self.keys.shape[0] - 1)
        return pos, (self.keys[pos] == q) & (r < self.n) & (c < self.n)

    def lookup(self, val, r, c):
        """The value of edge (r, c) (0 where there is none) and whether it
        exists."""
        pos, found = self.find(r, c)
        return torch.where(found, val[pos], 0), found

    def col_edges(self, cols):
        """The positions of every edge in columns ``cols``."""
        start = self.col_ptr[cols]
        count = self.col_ptr[cols + 1] - start
        total = int(count.sum())
        first = torch.repeat_interleave(start - (torch.cumsum(count, 0)
                                                 - count), count,
                                        output_size=total)
        return self.by_col[first + torch.arange(total, device=cols.device)]

    def free_mates(self):
        n = self.n
        full = torch.full((n + 1,), n, dtype=I64, device=self.row.device)
        return full, full.clone()

    def duals(self, val, mate_col):
        n = self.n
        u = torch.zeros(n + 1, dtype=self.dtype, device=val.device)
        u[:n], _ = self.lookup(val, self.jvec, mate_col[:n])
        return u

    # ----------------------------------------------------------------- phases
    def greedy(self, val):
        """Rounds of proposals: each free column proposes to its heaviest
        free row, each row takes its heaviest proposal."""
        n, row, col = self.n, self.row, self.col
        mr, mc = self.free_mates()
        while True:
            avail = self.real & (mc[row] == n) & (mr[col] == n)
            pv, pe = argmax_by(torch.where(avail, val, NEG), self.eidx,
                               torch.where(avail, col, n), n + 1)
            has = pe[:n] >= 0
            prow = torch.where(has, row[pe[:n].clamp(min=0)], n)
            _, rj = argmax_by(torch.where(has, pv[:n], NEG), self.jvec, prow,
                              n + 1)
            won = (rj[:n] >= 0).nonzero().squeeze(1)
            if won.numel() == 0:
                return mr, mc
            mc[won] = rj[won]
            mr[rj[won]] = won

    def bfs(self, val, mr, mc):
        """One layered BFS from every free column to the first layer that
        reaches a free row; each newly reached row takes its heaviest edge
        into the frontier as its parent (over the frontier columns' edges
        alone, which are all the edges that can qualify)."""
        n, row, col = self.n, self.row, self.col
        dev = row.device
        frontier = (mr[:n] == n).nonzero().squeeze(1)
        parent = torch.full((n + 1,), n, dtype=I64, device=dev)
        visited = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        found, progressed, layers = False, True, 0
        while not found and progressed and layers <= n:
            e = self.col_edges(frontier)
            re = row[e]
            elig = ~visited[re]
            _, pe = argmax_by(torch.where(elig, val[e], NEG), e,
                              torch.where(elig, re, n), n + 1)
            new = pe[:n] >= 0
            parent[:n] = torch.where(new, col[pe[:n].clamp(min=0)],
                                     parent[:n])
            visited[:n] |= new
            free_new = new & (mc[:n] == n)
            frontier = mc[:n][new & ~free_new]
            layers += 1
            found, progressed = bool(free_new.any()), bool(new.any())
        return parent, visited, found, layers

    def flip(self, parent, visited, layers: int, mr, mc):
        """Walk back from every free row reached, all in step; a column
        claimed by two walkers goes to the smaller row and the other
        walker stops. Then flip each surviving path."""
        n = self.n
        dev = mr.device
        walker = (visited[:n] & (mc[:n] == n)).nonzero().squeeze(1)
        active = torch.ones_like(walker, dtype=torch.bool)
        cur = walker
        for _ in range(layers):
            j = torch.where(active, parent[cur], n)
            claim = torch.full((n + 1,), BIG, dtype=I64, device=dev)
            claim = claim.scatter_reduce(0, j, torch.where(active, walker,
                                                           BIG), "amin",
                                         include_self=True)
            active = active & (claim[j] == walker)
            nxt = mr[j]
            cur = torch.where(active & (nxt < n), nxt, cur)
        surv, cur = active, walker
        mr, mc = mr.clone(), mc.clone()
        for _ in range(layers):
            j = torch.where(surv, parent[cur], n)
            prev = mr[j]
            mr[j] = torch.where(surv, cur, prev)
            mc[torch.where(surv, cur, n)] = j
            mr[n] = n
            mc[n] = n
            surv = surv & (prev < n)
            cur = torch.where(surv, prev, cur)
        return mr, mc

    def mcm(self, val, mr, mc):
        """Phases of BFS and flips until no free column is left or a BFS
        finds no augmenting path."""
        n = self.n
        while bool((mr[:n] == n).any()):
            parent, visited, found, layers = self.bfs(val, mr, mc)
            if not found:
                break
            mr, mc = self.flip(parent, visited, layers, mr, mc)
        return mr, mc

    def winners(self, val, mr, mc, u, v):
        """Each column's best augmenting 4-cycle: (gain, row, w1, w2)."""
        n, row, col = self.n, self.row, self.col
        qr, qc = mr[col], mc[row]
        w2, found = self.lookup(val, qr, qc)
        gain = val + w2 - u[row] - v[col]
        cand = found & self.real & (row > qr) & (
            gain > torch.tensor(MIN_GAIN, dtype=self.dtype))
        g, e = argmax_by(torch.where(cand, gain, NEG), self.eidx,
                         torch.where(cand, col, n), n + 1)
        g, e = g[:n], e[:n]
        has, ec = e >= 0, e.clamp(min=0)
        return (g, torch.where(has, row[ec], n),
                torch.where(has, val[ec], 0), torch.where(has, w2[ec], 0))

    def augment(self, g, ci, w1, w2, mr, mc, u, v):
        """Keep, for each e2 column (the column of the winner's row), the
        best cycle rooted at it unless that column is a root itself; with
        none kept, the single best cycle. Swap every kept cycle."""
        n = self.n
        dev = g.device
        rooted = g > NEG
        e2 = torch.where(rooted, mc[ci.clamp(max=n)], n)
        dg, dj = argmax_by(torch.where(rooted, g, NEG), self.jvec, e2, n + 1)
        keep_e2 = (dg[:n] > NEG) & ~rooted
        mask = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        mask[torch.where(keep_e2, dj[:n], n)] = True
        mask = mask[:n] & rooted
        if not bool(mask.any()) and bool(rooted.any()):
            top = g[rooted].max()
            first = torch.where(rooted & (g == top), self.jvec, BIG).min()
            mask = self.jvec == first
        js = mask.nonzero().squeeze(1)
        i, j = ci[js], js
        r2, c2 = mr[j], mc[i]
        mr, mc, u, v = mr.clone(), mc.clone(), u.clone(), v.clone()
        mr[j], mr[c2] = i, r2
        mc[i], mc[r2] = j, c2
        u[i], u[r2] = w1[js], w2[js]
        v[j], v[c2] = w1[js], w2[js]
        for x in (mr, mc):
            x[n] = n
        u[n] = 0
        v[n] = 0
        return mr, mc, u, v, int(js.numel())

    def awac(self, val, mr, mc):
        """AWAC rounds from a perfect matching (none from an imperfect
        one) until a round keeps no cycle, or ``MAX_ITER`` rounds."""
        n = self.n
        u = self.duals(val, mc)
        v = torch.zeros_like(u)
        v[:n] = torch.where(mr[:n] < n, u[mr[:n]], 0)
        rounds = 0
        go = bool((mr[:n] < n).all())
        while go and rounds < MAX_ITER:
            mr, mc, u, v, kept = self.augment(*self.winners(val, mr, mc, u, v),
                                              mr, mc, u, v)
            rounds += 1
            go = kept > 0
        return Answer(mr, mc, u, rounds)

    # ------------------------------------------------------------------ calls
    def cold(self, val) -> Answer:
        """Greedy, MCM and AWAC from nothing."""
        val = val.to(self.dtype)
        mr, mc = self.greedy(val)
        mr, mc = self.mcm(val, mr, mc)
        return self.awac(val, mr, mc)

    def repair(self, seed_row, seed_col):
        """The pairs of a seed that are mutual and still edges."""
        n = self.n
        mr = seed_row.to(I64)[:n]
        valid = (mr >= 0) & (mr < n)
        i = torch.where(valid, mr, n)
        mutual = seed_col.to(I64)[i.clamp(max=n)] == self.jvec
        _, exists = self.find(i, self.jvec)
        keep = valid & mutual & exists
        new_r, new_c = self.free_mates()
        new_r[:n] = torch.where(keep, mr, n)
        new_c[mr[keep]] = self.jvec[keep]
        return new_r, new_c

    def warm(self, val, seed_row, seed_col) -> Answer:
        """The seed repaired, topped up by MCM, then AWAC."""
        val = val.to(self.dtype)
        mr, mc = self.repair(seed_row, seed_col)
        mr, mc = self.mcm(val, mr, mc)
        return self.awac(val, mr, mc)


def preflight_issues(row, col, val, n: int) -> set[str]:
    """The kinds of finding a screen of the problem reports: non-finite,
    negative or duplicate entries, empty rows or columns."""
    real = (row < n) & (col < n)
    r, c, v = row[real].to(I64), col[real].to(I64), val[real]
    out = set()
    if not bool(torch.isfinite(v).all()):
        out.add("nonfinite_weight")
    if bool((v < 0).any()):
        out.add("negative_weight")
    keys = torch.sort(r * (n + 1) + c).values
    if bool((keys[1:] == keys[:-1]).any()):
        out.add("duplicate_edge")
    if bool((torch.bincount(r, minlength=n) == 0).any()):
        out.add("empty_row")
    if bool((torch.bincount(c, minlength=n) == 0).any()):
        out.add("empty_col")
    return out
