"""Mixture-of-Experts layer with two routers (the port of the JAX
package's ``models/moe.py``):

- ``topk``: the literature-faithful baseline (softmax gate, top-k, capacity
  dropping, load-balancing aux loss) — what qwen2-moe / deepseek-moe ship.
- ``awpm``: the paper's technique applied to routing (DESIGN.md §4): a
  greedy balanced assignment (the maximal-matching phase), then rounds of
  mutual-best positive-gain token swaps (the AWAC phase's 4-cycles). Its
  per-column best swap partners come from K4 (``kernels/router_swap``): the
  CUDA kernel on the card, its plain version on the CPU.

Dispatch is grouped and sort-free, as in the JAX package: each group of
tokens is routed and scattered into its own [E, C, d] buffer, with one
dump row for dropped entries.

Tie order is the JAX package's, and the routing depends on it: the router
logits are bf16, padded tokens have all-zero logits, and from the second
routing round on used experts sit at ``aff - 1e6``, where float32 steps by
0.0625. ``jax.lax.top_k`` returns tied entries in index order;
``torch.topk`` does not, so the port takes the first entries of a stable
descending ``torch.sort``. ``jnp.argmax`` and ``torch.argmax`` both return
the first maximum. Expert ids and slots are int64 (torch's index type;
int32 in JAX).

``balanced_assign_batched`` reads one flag from the device per proposal
round (``active.any()``), as the JAX ``while_loop`` tests it: running to
``max_iters`` under the masks gives the same result, because a frozen group
accepts nothing, but runs every round. On the ``meta`` device, where
nothing can be read, it does just that (the dry run's route); K4's
wrapper has a ``meta`` route of its own (``kernels/router_swap``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.api import MatchingProblem, SolveOptions, solve
from repro_torch.kernels.router_swap.ops import router_swap_padded_batched
from repro_torch.models.act_sharding import constrain
from repro_torch.models.layers import MLP, Dense
from repro_torch.models.param import dense_init

NEG = float("-inf")


class Experts(nn.Module):
    """Stacked SwiGLU experts in the JAX layout: ``gate`` and ``up``
    [E, d, ff], ``down`` [E, ff, d] (products ``x @ w``)."""

    def __init__(self, e: int, d: int, ff: int, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.gate = nn.Parameter(torch.empty(e, d, ff, device=device))
        self.up = nn.Parameter(torch.empty(e, d, ff, device=device))
        self.down = nn.Parameter(torch.empty(e, ff, d, device=device))
        dense_init(self.gate, gen, fan_in=d)
        dense_init(self.up, gen, fan_in=d)
        dense_init(self.down, gen, fan_in=ff)


class MoE(nn.Module):
    """The parameters of ``moe_def``: ``router`` (d -> E), ``experts``,
    and, with shared experts, ``shared`` (a SwiGLU MLP) and its sigmoid
    ``shared_gate`` (d -> 1)."""

    def __init__(self, cfg, moe, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        d = cfg.d_model
        e, ff = moe.n_experts, moe.d_ff_expert
        self.router = Dense(d, e, device=device, gen=gen)
        self.experts = Experts(e, d, ff, device=device, gen=gen)
        self.shared = self.shared_gate = None
        if moe.n_shared:
            self.shared = MLP(d, moe.d_ff_shared or moe.n_shared * ff,
                              device=device, gen=gen)
            if moe.shared_gate:
                self.shared_gate = Dense(d, 1, device=device, gen=gen)


# --------------------------- routers ---------------------------------------


def _top_sorted(x, k: int):
    """The k largest entries along the last axis and their indices, ties
    in index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rank_in_expert(experts, e: int):
    """For ids [..., N], the count of earlier entries (along N) with the
    same id."""
    onehot = F.one_hot(experts, e)
    ranks = torch.cumsum(onehot, dim=-2) - onehot
    return torch.gather(ranks, -1, experts[..., None])[..., 0]


def topk_route_batched(logits, k: int, capacity: int):
    """``topk_route`` for G groups: logits [G, T, E]. Returns (expert
    [G,T,k], slot [G,T,k], weight [G,T,k], keep [G,T,k], aux [G])."""
    g, t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = _top_sorted(probs, k)  # [G, T, k]
    w = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    # rank within expert over flattened (token-major) choices
    slot = _rank_in_expert(topi.reshape(g, t * k), e).reshape(g, t, k)
    keep = slot < capacity
    # aux load-balance loss (Switch-style)
    frac_tokens = F.one_hot(topi[..., 0], e).float().mean(dim=1)
    frac_probs = probs.mean(dim=1)
    aux = e * (frac_tokens * frac_probs).sum(-1)
    return topi, slot, w.to(logits.dtype), keep, aux


def topk_route(logits, k: int, capacity: int):
    """Faithful baseline. logits [T, E]. Returns (expert [T,k], slot [T,k],
    weight [T,k], keep [T,k], aux_loss). Slot is rank-within-expert;
    tokens beyond ``capacity`` are dropped."""
    out = topk_route_batched(logits[None], k, capacity)
    return tuple(x[0] for x in out)


def balanced_assign_batched(aff, capacity: int, max_iters: int | None = None):
    """Greedy balanced assignment for G groups: proposal rounds with
    per-expert top-capacity acceptance under per-group convergence masks,
    then a round-robin cleanup so that every token is assigned and every
    expert holds exactly ``capacity`` tokens. aff [G, T, E] (-inf =
    forbidden). Returns assigned [G, T] int64."""
    g, t, e = aff.shape
    if t != e * capacity:
        raise ValueError(f"tokens {t} != experts {e} x capacity {capacity}")
    max_iters = max_iters or (e + 8)
    dev = aff.device
    erange = torch.arange(e, device=dev)
    crange = torch.arange(capacity, device=dev)
    aff_et = aff.transpose(1, 2)  # [G, E, T]
    assigned = torch.full((g, t + 1), -1, dtype=torch.long, device=dev)
    cap = torch.full((g, e), capacity, dtype=torch.long, device=dev)
    active = torch.ones(g, dtype=torch.bool, device=dev)
    it = 0
    meta = dev.type == "meta"  # no flag to read: every round, masked
    while it < max_iters and (meta or bool(active.any())):
        blocked = (assigned[:, :t, None] >= 0) | (cap <= 0)[:, None, :]
        aff_m = aff.masked_fill(blocked, NEG)
        best_v = aff_m.amax(dim=2)
        best_e = aff_m.argmax(dim=2)  # the first maximum, as jnp.argmax
        prop = ((best_v > NEG)[:, None, :]
                & (best_e[:, None, :] == erange[None, :, None]))
        vals, idxs = _top_sorted(torch.where(prop, aff_et, NEG), capacity)
        ok = ((vals > NEG) & (crange < cap[:, :, None])
              & active[:, None, None])  # frozen groups accept nothing
        tok = torch.where(ok, idxs, t).reshape(g, -1)
        exp = torch.where(ok, erange[None, :, None], 0).reshape(g, -1)
        # a token proposes to one expert: only the dump column t repeats,
        # and it is never read
        assigned.scatter_(1, tok, exp)
        cap = cap - ok.sum(dim=2)
        active = active & (assigned[:, :t] < 0).any(dim=1)
        it += 1
    assigned = assigned[:, :t]
    # cleanup: r-th remaining token -> expert owning the r-th free slot
    rem = assigned < 0
    rank = torch.cumsum(rem.long(), dim=1) - 1
    free_cum = torch.cumsum(cap, dim=1)
    slot_expert = torch.searchsorted(free_cum, rank, right=True)
    return torch.where(rem, slot_expert, assigned)


def balanced_assign(aff, capacity: int, max_iters: int | None = None):
    """Single-group wrapper over ``balanced_assign_batched``. aff [T, E]."""
    return balanced_assign_batched(aff[None], capacity, max_iters)[0]


def swap_improve_batched(aff, assign, rounds: int, min_gain: float = 1e-6,
                         use_kernel: bool = True):
    """AWAC on the router for G groups: ``rounds`` rounds of mutual-best
    positive-gain token swaps, applied as a vertex-disjoint set per round.
    Tokens never swap across groups; perfect balance is kept exactly.
    aff [G, T, E] float32, assign [G, T]. The best partner of each token
    comes from K4 (``use_kernel``) or from the dense plain search.

    K4 reports partner -1 where a token has no candidate, where JAX's
    ``argmax`` gives 0; the gain there is -inf, so neither can pass
    ``gain > min_gain``, and -1 is read as 0 where a partner's own partner
    is looked up."""
    g, t = assign.shape
    tvec = torch.arange(t, device=aff.device)
    assign = assign.long()
    for _ in range(rounds):
        cur = torch.gather(aff, 2, assign[..., None])[..., 0]
        gain, bp = router_swap_padded_batched(aff, assign, cur,
                                              use_kernel=use_kernel)
        bp = bp.long()
        bp0 = bp.clamp_min(0)
        mutual = ((torch.gather(bp0, 1, bp0) == tvec) & (gain > min_gain)
                  & (tvec < bp))
        swap_with = torch.cat([torch.where(mutual, bp, tvec),
                               torch.full((g, 1), t, device=aff.device)], 1)
        swap_with.scatter_(1, torch.where(mutual, bp, t),
                           torch.where(mutual, tvec, t))
        assign = torch.gather(assign, 1, swap_with[:, :t])
    return assign


def swap_improve(aff, assign, rounds: int, min_gain: float = 1e-6,
                 use_kernel: bool = True):
    """Single-group wrapper over ``swap_improve_batched``."""
    return swap_improve_batched(aff[None], assign[None], rounds, min_gain,
                                use_kernel)[0]


def _round_slots(experts, capacity_per_round: int, e: int):
    """Slots of k routing rounds: round r occupies [r*C, (r+1)*C), rank
    within (expert, round)."""
    return torch.stack([_rank_in_expert(a, e) + r * capacity_per_round
                        for r, a in enumerate(experts)], dim=2)


def awpm_route_batched(logits, k: int, capacity_per_round: int,
                       swap_rounds: int, use_kernel: bool = True):
    """Batched AWPM routing (DESIGN.md §4): k rounds of balanced assignment
    and 4-cycle improvement for all G groups; round r penalizes experts
    already used by the token by 1e6 (a soft constraint). logits
    [G, T, E]. Returns (expert [G,T,k], slot [G,T,k], weight [G,T,k],
    keep (all True), aux (0))."""
    g, t, e = logits.shape
    aff = logits.float()
    used = torch.zeros((g, t, e), dtype=torch.bool, device=logits.device)
    experts = []
    for _ in range(k):
        a_r = torch.where(used, aff - 1e6, aff)
        assign = balanced_assign_batched(a_r, capacity_per_round)
        assign = swap_improve_batched(a_r, assign, swap_rounds,
                                      use_kernel=use_kernel)
        used = used | F.one_hot(assign, e).bool()
        experts.append(assign)
    topi = torch.stack(experts, dim=2)
    slot = _round_slots(experts, capacity_per_round, e)
    w = torch.softmax(torch.gather(aff, 2, topi), dim=-1).to(logits.dtype)
    keep = torch.ones((g, t, k), dtype=torch.bool, device=logits.device)
    return topi, slot, w, keep, torch.zeros((), device=logits.device)


def awpm_route(logits, k: int, capacity_per_round: int, swap_rounds: int,
               use_kernel: bool = True):
    """Single-group wrapper over ``awpm_route_batched``. logits [T, E]."""
    topi, slot, w, keep, aux = awpm_route_batched(
        logits[None], k, capacity_per_round, swap_rounds, use_kernel)
    return topi[0], slot[0], w[0], keep[0], aux


def matching_route_batched(logits, k: int, capacity_per_round: int,
                           dist_spec=None, max_iter: int = 1000):
    """Exact BASE-layers routing through the port's matching engine: each
    round, the token -> expert-slot assignment is a heavy-weight perfect
    matching on the dense (token x slot) bipartite graph (slot s belongs to
    expert s // capacity_per_round), solved for all G groups in one batched
    ``solve`` (K2 on the card), or on the 2D process grid ``dist_spec``
    (a ``core.dist.GridSpec``; every rank routes the same logits). Same
    contract as ``awpm_route_batched``."""
    g, t, e = logits.shape
    if t != e * capacity_per_round:
        raise ValueError(f"tokens {t} != slots {e * capacity_per_round}")
    dev = logits.device
    aff = logits.float()
    used = torch.zeros((g, t, e), dtype=torch.bool, device=dev)
    tvec = torch.arange(t, dtype=torch.int32, device=dev)
    # dense (token x slot) COO, row-major == lex-sorted by (row, col)
    row = tvec.repeat_interleave(t).expand(g, t * t).contiguous()
    col = tvec.repeat(t).expand(g, t * t).contiguous()
    opts = SolveOptions(max_iter=max_iter, grid=dist_spec)
    experts, slots = [], []
    for r in range(k):
        a_r = torch.where(used, aff - 1e6, aff)
        # val[g, i*t + s] = a_r[g, i, s // C]; the assignment is discrete,
        # so the matching sees the affinities without their graph
        val = a_r.detach().repeat_interleave(capacity_per_round,
                                             dim=2).reshape(g, t * t)
        res = solve(MatchingProblem(row=row, col=col, val=val, n=t), opts)
        slot_of = res.mate_col[:, :t].long()  # token -> slot
        assign = slot_of // capacity_per_round
        used = used | F.one_hot(assign, e).bool()
        experts.append(assign)
        slots.append(slot_of % capacity_per_round + r * capacity_per_round)
    topi = torch.stack(experts, dim=2)
    w = torch.softmax(torch.gather(aff, 2, topi), dim=-1).to(logits.dtype)
    return (topi, torch.stack(slots, dim=2), w,
            torch.ones((g, t, k), dtype=torch.bool, device=dev),
            torch.zeros((), device=dev))


# --------------------------- dispatch + layer --------------------------------


def _expert_ffn_grouped(pe: Experts, xe):
    """xe [G, E, C, d] -> [G, E, C, d] through per-expert SwiGLU. The
    float32 expert weights are cast to xe's dtype at use, as in JAX; the
    products are plain batched matrix products (JAX leaves them to XLA)."""
    wg, wu, wd = (constrain(w.to(xe.dtype), "w_expert")
                  for w in (pe.gate, pe.up, pe.down))
    g = torch.einsum("gecd,edf->gecf", xe, wg)
    u = torch.einsum("gecd,edf->gecf", xe, wu)
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, wd)


def _pad_rows(x, rows: int):
    """x [N, ...] zero-padded to ``rows`` rows."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])


def _group_size(t: int, moe) -> int:
    """Tokens per dispatch group: ``router_block`` for the AWPM router,
    ``t / dispatch_groups`` for top-k (all ``t`` when 0)."""
    if moe.router == "awpm":
        return min(moe.router_block or t, t)
    return t // max(moe.dispatch_groups, 1) if moe.dispatch_groups else t


def awpm_blocks(logits, moe):
    """The AWPM router's input for one layer's router logits [T, E]:
    (logits [G, tbp, E], capacity per round). Each group of ``gb`` tokens
    (``router_block``; the last one padded with zero logits) is padded
    with all-zero logits to ``tbp``, a multiple of E, so that every expert
    takes ``tbp / E`` tokens a round; the swap-gain matrix is then
    [tbp, tbp] per group, never [T, T]."""
    t, e = logits.shape
    gb_sz = _group_size(t, moe)
    n_g = -(-t // gb_sz)
    tbp = -(-gb_sz // e) * e
    lgp = logits.new_zeros((n_g, tbp, e))
    lgp[:, :gb_sz] = _pad_rows(logits, n_g * gb_sz).reshape(n_g, gb_sz, e)
    return lgp, tbp // e


def moe_apply(p: MoE, x, cfg, moe, dist_spec=None):
    """x [B, S, d] -> (y [B, S, d], aux_loss).

    Dispatch is grouped: tokens are split into G groups (``router_block``
    for the AWPM router; ``dispatch_groups`` for top-k; G = 1 is global
    dispatch), each routed and scattered into its own [E, C_g, d] buffer.
    An AWPM group of ``gb`` tokens is padded with all-zero logits to a
    multiple of E and routed with a per-round capacity of that over E.
    ``dist_spec`` (AWPM only, a ``core.dist.GridSpec``) routes through
    ``matching_route_batched`` on that process grid."""
    b, s, d = x.shape
    t = b * s
    e, k = moe.n_experts, moe.top_k
    xt = x.reshape(t, d)
    logits = p.router(xt)

    gb_sz = _group_size(t, moe)
    n_g = -(-t // gb_sz)
    tpad = n_g * gb_sz
    x_g = _pad_rows(xt, tpad).reshape(n_g, gb_sz, d)

    if moe.router == "awpm":
        lgp, cap_round = awpm_blocks(logits, moe)
        capacity = k * cap_round
        if dist_spec is not None:
            ti, sl, ww, _, _ = matching_route_batched(lgp, k, cap_round,
                                                      dist_spec=dist_spec)
        else:
            ti, sl, ww, _, _ = awpm_route_batched(lgp, k, cap_round,
                                                  moe.router_swap_rounds)
        topi, slot, w = ti[:, :gb_sz], sl[:, :gb_sz], ww[:, :gb_sz]
        keep = torch.ones((n_g, gb_sz, k), dtype=torch.bool, device=x.device)
        aux = torch.zeros((), device=x.device)
    else:
        capacity = int(moe.capacity_factor * k * gb_sz / e) + 1
        logits_g = _pad_rows(logits, tpad).reshape(n_g, gb_sz, e)
        topi, slot, w, keep, aux = topk_route_batched(logits_g, k, capacity)
        aux = aux.mean()
    aux = aux * moe.aux_loss_coef

    c = capacity
    flat_idx = torch.where(keep, topi * c + slot, e * c).reshape(
        n_g, gb_sz * k)
    src = x_g.repeat_interleave(k, dim=1)  # [G, gb*k, d]
    # dropped entries all land on the dump row e * c, which is cut off
    buf = xt.new_zeros((n_g, e * c + 1, d))
    buf.scatter_(1, flat_idx[..., None].expand(-1, -1, d), src)
    buf = constrain(buf[:, :-1].reshape(n_g, e, c, d), "moe_buf4")
    ye = constrain(_expert_ffn_grouped(p.experts, buf), "moe_buf4")
    ye = ye.reshape(n_g, e * c, d)
    gathered = torch.gather(ye, 1, flat_idx.clamp(0, e * c - 1)[..., None]
                            .expand(-1, -1, d))
    gathered = torch.where((flat_idx < e * c)[..., None], gathered, 0.0)
    yt = (gathered.reshape(n_g, gb_sz, k, d) * w[..., None].to(xt.dtype)
          ).sum(dim=2).reshape(tpad, d)[:t]

    if p.shared is not None:
        sh = p.shared(xt)
        if p.shared_gate is not None:
            sh = sh * torch.sigmoid(p.shared_gate(xt).float()).to(xt.dtype)
        yt = yt + sh
    return yt.reshape(b, s, d), aux


def router_stats(logits, topi, n_experts: int):
    """Diagnostics: per-expert load fractions + mean selected affinity.
    logits [T, E], topi [T, k]."""
    load = torch.bincount(topi.reshape(-1), minlength=n_experts)
    sel = torch.gather(logits, 1, topi)
    return {"load": load, "mean_affinity": sel.mean(),
            "load_cv": load.float().std(correction=0)
            / load.float().mean().clamp_min(1e-9)}
