"""EquiformerV2 (arXiv:2306.12059): eSCN-style equivariant graph attention
(the port of the JAX package's ``models/gnn/equiformer_v2.py``;
parameters as ``equiformer_def`` names them).

Node states are irrep features X [N, (l_max+1)^2, C] (l_max=6 -> 49
components, C channels). Per layer (structure follows the paper; the
full Wigner rotation into per-edge frames is simplified to global-frame
SO(2)-restricted mixing, as in the JAX package):

  1. edge invariants: radial basis of |r_ij| + per-degree norms of X_i
  2. multi-head attention weights from invariants (n_heads scalar heads,
     each repeated over its C / n_heads channels: ``repeat_interleave``)
  3. messages: per-degree channel mix of X_i, modulated per (l, channel)
     by a radial MLP, PLUS spherical-harmonic injection Y_lm(r_ij) (x) the
     channel map of the scalar part; only components with |m| <= m_max
     take part in the mixing (the eSCN restriction). With the config's
     ``escn_subspace`` the state itself carries only those components.
  4. segment-sum aggregation, equivariant RMS norm per degree, gated
     nonlinearity (scalar gate per channel from the l=0 part)

Output head: invariant (l=0) features -> node outputs. The compute dtype
is ``node_feat``'s dtype.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.single import resolve_device
from repro_torch.models.act_sharding import constrain
from repro_torch.models.gnn.common import (
    MLP2,
    GraphBatch,
    node_or_graph_loss,
    radial_basis,
    real_spherical_harmonics,
    sh_degree_index,
    take,
)
from repro_torch.models.layers import Dense
from repro_torch.models.param import dense_init, generator
from repro_torch.sparse.ops import segment_sum

N_RAD = 8


class Layer(nn.Module):
    def __init__(self, c: int, n_l: int, n_heads: int, device, gen):
        super().__init__()
        self.inv_mlp = MLP2(n_l * c + N_RAD, c, c, device=device, gen=gen)
        self.attn = Dense(c, n_heads, bias=True, device=device, gen=gen)
        self.mix = nn.Parameter(dense_init(
            torch.empty(n_l, c, c, device=device), gen, fan_in=c))
        self.rad_scale = Dense(c, n_l * c, device=device, gen=gen)
        self.sh_inject = Dense(c, c, device=device, gen=gen)
        self.gate = Dense(c, c, bias=True, device=device, gen=gen)
        self.norm_scale = nn.Parameter(torch.ones(n_l, c, device=device))


class EquiformerV2(nn.Module):
    def __init__(self, cfg, d_in: int, n_out: int, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        gen = generator(seed, device)
        c = cfg.d_hidden
        n_l = cfg.opt("l_max", 6) + 1
        n_heads = cfg.opt("n_heads", 8)
        self.embed = Dense(d_in, c, bias=True, device=device, gen=gen)
        self.layers = nn.ModuleList(Layer(c, n_l, n_heads, device, gen)
                                    for _ in range(cfg.n_layers))
        self.head = MLP2(c, c, n_out, device=device, gen=gen)


def _degree_sq(x, ls, n_l: int):
    """Per-degree sums of squares: x [N, K, C] -> [N, n_l, C]; ``ls`` [K]
    holds each component's degree."""
    return segment_sum((x * x).transpose(0, 1), ls, n_l).transpose(0, 1)


def _degree_norm(x, ls, n_l: int):
    """Per-degree L2 norms: x [N, K, C] -> [N, n_l, C]."""
    return torch.sqrt(_degree_sq(x, ls, n_l) + 1e-12)


def _normalize(x, ls, n_l: int):
    """``x / _degree_norm(x)`` per component, with no gradient into a
    (node, degree, channel) block that is exactly zero.

    A node with no incoming edge keeps its l > 0 blocks at zero through
    every layer, and the norm's derivative there is 1 / sqrt(1e-12) =
    1e6: over a deep stack the gradient of those zeros overflows float32
    and meets them as inf * 0 = NaN. JAX's equiformer-v2 gives NaN
    gradients so at full depth (ROADMAP.md, Queue 3). Every parameter
    takes that gradient times an exact zero, so cutting it changes no
    finite gradient."""
    sq = _degree_sq(x, ls, n_l)
    live = take(sq != 0, ls, 1)
    return torch.where(live, x, x.detach()) / take(torch.sqrt(sq + 1e-12),
                                                   ls, 1)


def apply(params: EquiformerV2, gb: GraphBatch, cfg):
    n = gb.node_feat.shape[0]
    c = cfg.d_hidden
    l_max = cfg.opt("l_max", 6)
    m_max = cfg.opt("m_max", 2)
    n_l = l_max + 1
    ls_arr, ms_arr = sh_degree_index(l_max)
    dev = gb.node_feat.device

    dt = gb.node_feat.dtype  # compute dtype
    src = torch.clamp(gb.edge_src, 0, n - 1)
    dst = torch.clamp(gb.edge_dst, 0, n - 1)
    evalid = (gb.edge_src < n).to(dt)
    vec = (take(gb.coords, dst) - take(gb.coords, src)).float()
    dist = torch.linalg.vector_norm(vec, dim=-1)
    rbf = radial_basis(dist, N_RAD).to(dt) * evalid[:, None]
    sh = real_spherical_harmonics(vec, l_max).to(dt) * evalid[:, None]

    if cfg.opt("escn_subspace", False):
        # carry ONLY the |m| <= m_max components: the eSCN restriction
        # applied to the state itself (the dropped components never
        # interact under the global-frame simplification), which shrinks
        # every edge gather and message by K / K_sub
        sel = np.nonzero(np.abs(ms_arr) <= m_max)[0]
        ls_arr, ms_arr = ls_arr[sel], ms_arr[sel]
        sh = take(sh, torch.as_tensor(sel, device=dev), 1)
    k = len(ls_arr)
    m_ok = torch.as_tensor(np.abs(ms_arr) <= m_max, device=dev).to(dt)
    ls = torch.as_tensor(ls_arr, device=dev)

    # init: scalar (l=0) part from input features, higher degrees zero
    x0 = F.silu(params.embed(gb.node_feat)).to(gb.node_feat.dtype)
    x = torch.cat([x0[:, None, :], x0.new_zeros(n, k - 1, c)], dim=1)
    agg_dst = torch.where(gb.edge_src < n, dst, n)

    for lp in params.layers:
        xi = take(x, src)  # [E, K, C]
        # 1. invariants
        norms = _degree_norm(xi, ls, n_l).reshape(xi.shape[0], -1)
        inv = lp.inv_mlp(torch.cat([norms.to(dt), rbf], dim=-1))
        # 2. attention (per scalar head -> broadcast over its channels)
        att = torch.sigmoid(lp.attn(inv))  # [E, H]
        att = torch.repeat_interleave(att, c // att.shape[-1],
                                      dim=-1).to(dt)  # [E, C]
        # 3. messages: per-degree channel mix, radial modulation, eSCN
        # m-mask
        mixed = torch.einsum("ekc,kcd->ekd", xi, take(lp.mix, ls).to(dt))
        scale = lp.rad_scale(inv).reshape(-1, n_l, c)
        msg = mixed * take(scale, ls, 1)
        msg = msg * m_ok[None, :, None]
        # SH injection from the scalar channel map
        inj = lp.sh_inject(xi[:, 0, :])  # [E, C]
        msg = msg + sh[:, :, None] * inj[:, None, :]
        msg = constrain(msg * att[:, None, :] * evalid[:, None, None],
                        "edges3")
        # 4. aggregate + equivariant norm + gated nonlinearity
        agg = segment_sum(msg, agg_dst, n + 1)[:n]
        x = x + agg
        x = _normalize(x, ls, n_l).to(dt) * take(lp.norm_scale, ls)[None].to(
            dt)
        gate = torch.sigmoid(lp.gate(x[:, 0, :])).to(dt)
        x = constrain(x * gate[:, None, :], "nodes3")

    return params.head(x[:, 0, :])


def near_zero_leaves(model: EquiformerV2) -> set:
    """The leaves whose gradient is zero but for the 1e-12 inside the
    per-degree norm: all but the head, the last layer's gate and its
    norm_scale. The head reads the l = 0 component alone, after the last
    layer's norm, and degree 0 has one component, which that norm takes
    to +-norm_scale (x / sqrt(x^2 + 1e-12)); so the loss is piecewise
    constant in every parameter upstream of that norm, up to the 1e-12,
    in JAX as here (ROADMAP.md, Queue 3). Their gradients are float32
    noise, or come through that 1e-12 near a zero entry, where rounding
    moves them by a share of their own size: checks hold them against
    the model's largest gradient."""
    last = f"layers.{len(model.layers) - 1}."
    live = ("head.", last + "gate.", last + "norm_scale")
    return {n for n, _ in model.named_parameters() if not n.startswith(live)}


def loss_fn(params: EquiformerV2, gb: GraphBatch, cfg):
    return node_or_graph_loss(apply(params, gb, cfg), gb)
