"""Per-(arch x shape x mesh) dry-run cells: a step function, its arguments
as ``meta`` tensors and each argument's sharding (the port of the JAX
package's ``launch/input_specs.py``). Nothing is allocated: a model is
built on ``meta`` (``build_defs(cfg, device="meta")``), and so are its
optimizer state, batches, KV caches and graph batches.

A spec is a tuple with one entry per dimension: a mesh-axis name, a tuple
of them, or None (replicated); ``()`` is a replicated scalar. ``in_specs``
mirrors ``args``: {name: spec} for a model's parameters, an ``OptState``
of such dicts, a dict per batch, a ``GraphBatch`` of specs.

Sharded dimensions that do not divide the mesh axes they shard over are
padded up, as in the JAX package: every model uses sentinel or mask
semantics, so padding is inert.

The matching cell runs the port's grid engine (``core/dist.py``) as one
rank of the 16 x 16 (or 2 x 16 x 16) grid: a ``fake`` process group of
256 (or 512) ranks carries its collectives, which check shapes and move
nothing, and its blocks are ``meta`` tensors of [cap] per rank. ``cap``
is the JAX package's, and the exchange capacities are
``safe_a2a_caps``'. Its arguments keep JAX's global shapes ([Pr, Pc,
cap] blocks, the replicated [n + 1] state); the step takes this rank's
block.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec, shapes_for
from repro_torch.data.graphs import (
    TRIPLET_FACTOR,
    graphcast_sizes,
    sampled_sizes,
)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_defs, build_loss, gnn_out_dim
from repro_torch.models.param import partition_specs
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import (
    AdamWConfig,
    abstract_opt_state,
    opt_specs,
)

META = torch.device("meta")
I32, F32 = torch.int32, torch.float32


@dataclasses.dataclass
class Cell:
    """One dry-run cell. ``fn(*args)`` is the step; ``policy`` the
    activation-sharding mapping its trace runs under (None: no policy,
    as the JAX cell has none); ``cfg`` and ``shape`` the config and shape
    cell it was built from, ``rules`` its parameter rules."""

    arch: str
    shape_name: str
    mode: str
    fn: Callable
    args: tuple
    in_specs: tuple
    mesh: mesh_lib.MeshSpec
    cfg: object
    shape: ShapeSpec
    rules: dict | None = None
    policy: dict | None = None
    note: str = ""


def _pad_to(n: int, mesh, axes) -> int:
    k = math.prod(mesh.shape[a] for a in axes) if axes else 1
    return -(-n // k) * k


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device=META)


OPT = AdamWConfig()


# --------------------------------- LM ---------------------------------------


def _lm_policy(cfg, mesh, b: int, rules, variants=()):
    """Activation-sharding policy of the LM family."""
    bax = mesh_lib.batch_axes(mesh) if b > 1 else None
    kvdiv = (cfg.n_kv_heads * cfg.hd) % mesh.shape["model"] == 0
    ep_ax = rules.get("experts")
    grouped = cfg.moe is not None and (cfg.moe.router == "awpm"
                                       or cfg.moe.dispatch_groups > 1)
    pol = {
        "lm_act": (bax, None, None),
        "lm_qkv": (bax, None, "model", None),
        "lm_kv": (bax, None, "model" if kvdiv else None, None),
        "lm_logits": (bax, None, "model"),
        "mlp_hidden": {3: (bax, None, "model"), 2: (bax, "model")},
        "moe_buf4": ((bax, ep_ax, None, None) if grouped
                     else (None, ep_ax, "data", None)),
    }
    if "fsdp_gather" in variants:
        pol["w_fsdp"] = {2: (None, "model")}
        pol["w_expert"] = {3: (ep_ax, None, rules.get("expert_mlp"))}
    return pol


def _lm_cells(arch, cfg, shape: ShapeSpec, mesh, variants=()):
    from repro_torch.models import transformer as T

    gsz = next((int(v.split(":")[1]) for v in variants
                if v.startswith("moe_ep:")), 2048)
    if any(v.startswith("moe_ep") for v in variants) and cfg.moe is not None:
        t_tokens = shape.d("global_batch") * (shape.d("seq_len")
                                              if shape.mode != "decode" else 1)
        groups = max(1, t_tokens // gsz)
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=groups))
    if "loss_chunk" in variants:
        cfg = dataclasses.replace(cfg, loss_chunks=8)
    rules = mesh_lib.lm_param_rules(cfg, mesh, variants)
    model = build_defs(cfg, device=META)
    pspecs = partition_specs(model, rules)
    batch_ax = mesh_lib.batch_axes(mesh)
    all_ax = mesh_lib.all_axes(mesh)
    s = shape.d("seq_len")
    b = shape.d("global_batch")
    pol = _lm_policy(cfg, mesh, b, rules, variants)
    common = dict(mesh=mesh, cfg=cfg, shape=shape, rules=rules, policy=pol)

    if shape.mode == "train":
        step = make_train_step(build_loss(cfg), OPT)
        batch = {"tokens": _meta((b, s), I32), "labels": _meta((b, s), I32),
                 "mask": _meta((b, s), F32)}
        bspec = {k: (batch_ax, None) for k in batch}
        return Cell(arch, shape.name, "train", step,
                    (model, abstract_opt_state(model), batch),
                    (pspecs, opt_specs(pspecs), bspec), **common)

    if shape.mode == "prefill":
        fn = functools.partial(_prefill_fn, cfg=cfg)
        return Cell(arch, shape.name, "prefill", fn,
                    (model, _meta((b, s), I32)), (pspecs, (batch_ax, None)),
                    **common)

    # decode: one new token against a seq-length-s KV cache
    cache = {group: tuple(_meta(*kv) for kv in pair)
             for group, pair in T.cache_shapes(cfg, b, s).items()}
    if b == 1:
        kv_spec = (None, None, all_ax, None, None)  # SP: seq over all axes
        tok_spec = ()
        note = "long-context decode: KV sequence-sharded over ALL axes"
    else:
        kv_spec = (None, batch_ax, "model", None, None)
        tok_spec = (batch_ax, None)
        note = "decode: batch over data axes, KV seq over model"
    cspec = {group: (kv_spec, kv_spec) for group in cache}
    fn = functools.partial(_decode_fn, cfg=cfg)
    return Cell(arch, shape.name, "decode", fn,
                (model, cache, _meta((b, 1), I32), _meta((), I32)),
                (pspecs, cspec, tok_spec, ()), note=note, **common)


def _prefill_fn(params, tokens, *, cfg):
    from repro_torch.models import transformer as T

    return T.prefill(params, tokens, cfg)


def _decode_fn(params, cache, token, pos, *, cfg):
    """``transformer.decode_step`` at position ``pos``. A ``meta`` scalar
    cannot be read; the step then writes the cache's last position (its
    work is the same at every position: the scores span the whole
    cache)."""
    from repro_torch.models import transformer as T

    s = next(iter(cache.values()))[0].shape[2]
    p = s - 1 if pos.device.type == "meta" else int(pos)
    return T.decode_step(params, cache, token, p, cfg)


# --------------------------------- GNN --------------------------------------


def _gnn_sizes(shape: ShapeSpec):
    if shape.name == "minibatch_lg":
        n, e = sampled_sizes(shape.d("batch_nodes"),
                             (shape.d("fanout1"), shape.d("fanout2")))
        return n, e, shape.d("d_feat", 602)
    if shape.name == "molecule":
        bsz = shape.d("batch")
        return shape.d("n_nodes") * bsz, shape.d("n_edges") * bsz, \
            shape.d("d_feat", 16)
    return shape.d("n_nodes"), shape.d("n_edges"), shape.d("d_feat", 100)


def _gnn_cells(arch, cfg, shape: ShapeSpec, mesh, variants=()):
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.models.gnn.graphcast import GraphCastBatch

    fdt = torch.bfloat16 if "gnn_bf16" in variants else F32
    shard_ax = mesh_lib.all_axes(mesh)  # graph entities shard over every axis
    rules = mesh_lib.gnn_param_rules(cfg, mesh)
    sp = (shard_ax,)

    if cfg.kind == "graphcast":
        ng0, _, _ = _gnn_sizes(shape)
        ng = _pad_to(ng0, mesh, shard_ax)
        sz = graphcast_sizes(ng)
        nm = _pad_to(sz["n_mesh"], mesh, shard_ax)
        nv = cfg.opt("n_vars", 227)

        def edges(key):
            return _meta((_pad_to(sz[key], mesh, shard_ax),), I32)

        batch = GraphCastBatch(
            grid_feat=_meta((ng, nv), F32),
            g2m_src=edges("e_g2m"), g2m_dst=edges("e_g2m"),
            mesh_src=edges("e_mesh"), mesh_dst=edges("e_mesh"),
            m2g_src=edges("e_m2g"), m2g_dst=edges("e_m2g"),
            target=_meta((ng, nv), F32), n_mesh=nm)
        bspec = GraphCastBatch(
            grid_feat=(shard_ax, None), g2m_src=sp, g2m_dst=sp, mesh_src=sp,
            mesh_dst=sp, m2g_src=sp, m2g_dst=sp, target=(shard_ax, None),
            n_mesh=nm)
    else:
        n0, e0, d_feat = _gnn_sizes(shape)
        n = _pad_to(n0, mesh, shard_ax)
        e = _pad_to(e0, mesh, shard_ax)
        coords = cfg.kind in ("dimenet", "equiformer_v2")
        n_graphs = shape.d("batch", 1)
        n_out = gnn_out_dim(shape.name)
        labels = (_meta((n_graphs, 1), F32) if n_out == 1
                  else _meta((n,), I32))
        tri = None
        if cfg.kind == "dimenet":
            pcap = _pad_to(TRIPLET_FACTOR * e, mesh, shard_ax)
            tri = (_meta((pcap,), I32), _meta((pcap,), I32))
        batch = GraphBatch(
            node_feat=_meta((n, d_feat), fdt),
            edge_src=_meta((e,), I32), edge_dst=_meta((e,), I32),
            labels=labels,
            coords=_meta((n, 3), fdt) if coords else None,
            graph_id=_meta((n,), I32) if n_graphs > 1 else None,
            triplets=tri, n_graphs=n_graphs)
        bspec = GraphBatch(
            node_feat=(shard_ax, None), edge_src=sp, edge_dst=sp,
            labels=((None, None) if n_out == 1 else sp),
            coords=(shard_ax, None) if coords else None,
            graph_id=sp if n_graphs > 1 else None,
            triplets=(sp, sp) if tri is not None else None,
            n_graphs=n_graphs)

    model = build_defs(cfg, shape, device=META)
    pspecs = partition_specs(model, rules)
    gpol = {"nodes": (shard_ax, None), "nodes3": (shard_ax, None, None),
            "edges": (shard_ax, None), "edges3": (shard_ax, None, None)}
    step = make_train_step(build_loss(cfg), OPT)
    return Cell(arch, shape.name, "train", step,
                (model, abstract_opt_state(model), batch),
                (pspecs, opt_specs(pspecs), bspec), mesh=mesh, cfg=cfg,
                shape=shape, rules=rules, policy=gpol)


# -------------------------------- RecSys ------------------------------------


def _recsys_cells(arch, cfg, shape: ShapeSpec, mesh):
    rules = mesh_lib.recsys_param_rules(cfg, mesh)
    model = build_defs(cfg, device=META)
    pspecs = partition_specs(model, rules)
    all_ax = mesh_lib.all_axes(mesh)
    b = _pad_to(shape.d("batch"), mesh, all_ax)
    sl = cfg.seq_len
    pol = {"rec_act": (all_ax, None, None)}
    common = dict(mesh=mesh, cfg=cfg, shape=shape, rules=rules)

    if shape.mode == "train":
        step = make_train_step(build_loss(cfg), OPT)
        batch = {"item_seq": _meta((b, sl), I32),
                 "labels": _meta((b, sl), I32), "mask": _meta((b, sl), F32)}
        bspec = {k: (all_ax, None) for k in batch}
        return Cell(arch, shape.name, "train", step,
                    (model, abstract_opt_state(model), batch),
                    (pspecs, opt_specs(pspecs), bspec), policy=pol, **common)

    if shape.mode == "serve":
        return Cell(arch, shape.name, "serve", _serve_fn,
                    (model, _meta((b, sl), I32)), (pspecs, (all_ax, None)),
                    policy=pol, **common)

    # retrieval: 1 user x 1M candidates (batched dot, candidate-sharded)
    nc = _pad_to(shape.d("n_candidates"), mesh, all_ax)
    return Cell(arch, shape.name, "retrieval", _retrieval_fn,
                (model, _meta((shape.d("batch"), sl), I32),
                 _meta((nc,), I32)),
                (pspecs, (None, None), (all_ax,)), **common)


def _serve_fn(params, seq):
    return params.serve_scores(seq)


def _retrieval_fn(params, seq, cands):
    return params.retrieval_scores(seq, cands)


# ------------------------------- Matching -----------------------------------


def fake_world(size: int):
    """A default process group of ``size`` ranks on the ``fake`` backend,
    this process being rank 0: its collectives check their tensors and
    move nothing (``torch.testing``'s fake process group). An earlier
    fake group of another size is replaced; any other group raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "the matching cell traces one rank on a fake process group "
                "and needs a process with no other default group")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=size,
                            store=FakeStore())


def _grid_spec(mesh):
    """This rank's ``core.dist.GridSpec`` on the mesh's grid: rows over the
    batch axes, columns over "model", groups on the fake process group."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.core.dist import GridSpec

    row_axes = mesh_lib.batch_axes(mesh)
    pr = math.prod(mesh.shape[a] for a in row_axes)
    pc = mesh.shape["model"]
    fake_world(pr * pc)
    ranks = np.arange(pr * pc).reshape(pr, pc)
    rows = [dist.new_group(ranks[r].tolist()) for r in range(pr)]
    cols = [dist.new_group(ranks[:, c].tolist()) for c in range(pc)]
    a, b = divmod(dist.get_rank(), pc)
    return GridSpec(pr, pc, a, b, rows[a], cols[b], META), row_axes


def _matching_cells(arch, cfg, shape: ShapeSpec, mesh, packed: bool = False):
    from repro_torch.core.dist import _make_awpm_dist_batched, safe_a2a_caps
    from repro_torch.core.single import MatchState

    spec, row_axes = _grid_spec(mesh)
    n = shape.d("n")
    m = int(n * shape.d("avg_degree"))
    cap = _pad_to(int(1.5 * m / (spec.pr * spec.pc)) + 64, mesh, ())
    run = _make_awpm_dist_batched(
        spec, n, 1, cap, safe_a2a_caps(cap, spec.pr, spec.pc),
        max_iter=cfg.max_iter, packed=packed, from_state=True)

    def step(brow, bcol, bval, state):
        mine = [x[spec.a, spec.b][None] for x in (brow, bcol, bval)]
        return run(*mine, *(f[None] for f in state))

    blk = (spec.pr, spec.pc, cap)
    state = MatchState(_meta((n + 1,), I32), _meta((n + 1,), I32),
                       _meta((n + 1,), F32), _meta((n + 1,), F32))
    ra = row_axes[0] if len(row_axes) == 1 else row_axes
    bs = (ra, "model", None)
    return Cell(arch, shape.name, "match", step,
                (_meta(blk, I32), _meta(blk, I32), _meta(blk, F32), state),
                (bs, bs, bs, MatchState((), (), (), ())), mesh=mesh, cfg=cfg,
                shape=shape, rules=mesh_lib.matching_rules(mesh), note=f"AWAC distributed rounds, n={n}, m~{m}, cap/blk={cap}")


# --------------------------------- entry ------------------------------------


def build_cell(arch: str, shape_name: str, mesh, router: str | None = None,
               cfg_override=None, variants: tuple = (),
               shape: ShapeSpec | None = None) -> Cell:
    """The cell of ``arch`` on its shape cell ``shape_name`` and ``mesh``.
    ``shape`` replaces the registry's cell of that name (a cell cut to
    fit fewer devices keeps its name and mode)."""
    cfg = cfg_override or get_config(arch)
    if cfg_override is None and cfg.family == "lm" and cfg.moe is not None \
            and router:
        cfg = get_config(arch, router=router)
    if "escn_sub" in variants and cfg.family == "gnn" \
            and cfg.kind == "equiformer_v2":
        cfg = dataclasses.replace(
            cfg, extra=cfg.extra + (("escn_subspace", True),))
    if shape is None:
        shape = next(s for s in shapes_for(cfg) if s.name == shape_name)
    fam = cfg.family
    if fam == "lm":
        return _lm_cells(arch, cfg, shape, mesh, variants)
    if fam == "gnn":
        return _gnn_cells(arch, cfg, shape, mesh, variants)
    if fam == "recsys":
        return _recsys_cells(arch, cfg, shape, mesh)
    if fam == "matching":
        return _matching_cells(arch, cfg, shape, mesh,
                               packed=("packed_a2a" in variants))
    raise ValueError(fam)


def materialize(cell: Cell, device, seed: int = 0) -> tuple:
    """The arguments of a model cell as real tensors on ``device``, drawn
    from ``seed``: the model (``build_defs``) and a fresh optimizer state;
    token and item ids in range, masks of ones, a KV cache of normals at
    its last position; graphs whose edges, triplets and graph ids stay in
    range. Shapes and dtypes are the cell's. The matching cell has no
    materialized form here (its step is one rank of a grid)."""
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.models.gnn.graphcast import GraphCastBatch
    from repro_torch.training.optimizer import OptState, init_opt_state

    cfg, dev = cell.cfg, torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "matching":
        raise ValueError("the matching cell runs on a fake process group")

    def ints(x, high):
        return torch.randint(0, max(int(high), 1), tuple(x.shape),
                             generator=gen, device=dev, dtype=x.dtype)

    def normal(x):
        return torch.randn(tuple(x.shape), generator=gen, device=dev,
                           dtype=x.dtype)

    model = build_defs(cfg, cell.shape if cfg.family == "gnn" else None,
                       device=dev, seed=seed)
    rest = []
    for a in cell.args[1:]:
        if isinstance(a, OptState):
            rest.append(init_opt_state(model))
        elif isinstance(a, dict) and cfg.family == "lm" and "tokens" in a:
            rest.append({"tokens": ints(a["tokens"], cfg.vocab),
                         "labels": ints(a["labels"], cfg.vocab),
                         "mask": torch.ones_like(a["mask"], device=dev)})
        elif isinstance(a, dict) and "item_seq" in a:
            rest.append({"item_seq": ints(a["item_seq"], cfg.n_items),
                         "labels": ints(a["labels"], cfg.n_items),
                         "mask": torch.ones_like(a["mask"], device=dev)})
        elif isinstance(a, dict):  # a KV cache
            rest.append({g: tuple(normal(x) for x in kv)
                         for g, kv in a.items()})
        elif isinstance(a, GraphCastBatch):
            ng, nm = a.grid_feat.shape[0], a.n_mesh
            rest.append(GraphCastBatch(
                grid_feat=normal(a.grid_feat), g2m_src=ints(a.g2m_src, ng),
                g2m_dst=ints(a.g2m_dst, nm), mesh_src=ints(a.mesh_src, nm),
                mesh_dst=ints(a.mesh_dst, nm), m2g_src=ints(a.m2g_src, nm),
                m2g_dst=ints(a.m2g_dst, ng), target=normal(a.target),
                n_mesh=nm))
        elif isinstance(a, GraphBatch):
            n, e = a.node_feat.shape[0], a.edge_src.shape[0]
            gid = None
            if a.graph_id is not None:
                gid = (torch.arange(n, device=dev) * a.n_graphs // n).to(I32)
            labels = (normal(a.labels) if a.labels.dtype.is_floating_point
                      else ints(a.labels, gnn_out_dim(cell.shape_name)))
            rest.append(GraphBatch(
                node_feat=normal(a.node_feat), edge_src=ints(a.edge_src, n),
                edge_dst=ints(a.edge_dst, n), labels=labels,
                coords=None if a.coords is None else normal(a.coords),
                graph_id=gid,
                triplets=None if a.triplets is None else tuple(
                    ints(t, e) for t in a.triplets),
                n_graphs=a.n_graphs))
        elif cfg.family == "lm" and a.dim() == 0:  # the decode position
            s = next(iter(cell.args[1].values()))[0].shape[2]
            rest.append(torch.tensor(s - 1, dtype=a.dtype, device=dev))
        else:  # token, item or candidate ids
            high = cfg.vocab if cfg.family == "lm" else cfg.n_items
            rest.append(ints(a, high))
    return (model, *rest)


def all_cells(arch: str):
    cfg = get_config(arch)
    return [s.name for s in shapes_for(cfg)]
