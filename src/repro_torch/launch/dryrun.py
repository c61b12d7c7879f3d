"""Multi-pod dry run (the port of the JAX package's ``launch/dryrun.py``).

For every (architecture x input shape) cell on the production meshes
(16 x 16 single-pod and 2 x 16 x 16 multi-pod, ``launch.mesh``), build
the cell on the ``meta`` device (``launch.input_specs``), run its step
once on the meta arguments, and record one JSON file per cell under
``results/torch/dryrun/``. Nothing is allocated and nothing runs on a
device; a cell that fails is a bug in the port.

  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]

What a trace measures (``measure``):

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the products),
  plus one operation per output element of every pointwise op and per
  input element of every reduction, scatter and index-add (as XLA's cost
  analysis counts elementwise work), plus the work of the hand-written
  kernels the step reaches (``roofline.analysis.kernel_work``: K5 and K4
  count their work on meta as at a launch);
- bytes: each op's input and output bytes (views, factories and
  collectives move none), plus the kernels' counted bytes;
- peak: the live storage the step creates beyond its arguments, each
  storage freed when the last tensor on it dies (its maximum is
  ``temp_bytes``; what the returned tensors hold is ``output_bytes``);
- collectives: every c10d collective by kind and bytes (the result's
  bytes, as XLA's HLO counts them). Only the matching cell has them: its
  step is one rank of the grid engine on a fake process group.

Nothing can be read from a ``meta`` tensor, so every host read on a
cell's path has a route of its own there, taken only on ``meta``: K5
(``kernels/flash_attention``) and K4 (``kernels/router_swap``) return
their outputs and count their work; the AWPM router's greedy loop
(``models/moe.py::balanced_assign_batched``) runs all its rounds under
its masks; ``core/batch.py::awac_loop`` runs one round; the finite-entry
filter of ``sparse/ops.py`` keeps every entry; a decode cell writes the
cache's last position (``input_specs._decode_fn``).

Per device: ``argument_bytes`` is exact, a ceil-division of every
argument over its spec. A model cell traces the whole (global) step, and
``flops_per_device``, ``bytes_per_device`` and ``temp_bytes`` are its
totals divided by the chips: an even-sharding estimate, which each
record's ``note`` states. The matching cell's come from its one-rank
trace. The port's LM unrolls its layers, so every layer is counted (the
JAX package's scan correction has no counterpart here).

The model cells run no collective in the port's code: ``reckon`` derives
them from the cell's specs and the ``act_sharding.constrain`` records,
by these rules (bytes are per device, of the result, as XLA's HLO
counts them):

1. A parameter sharded over the FSDP axis (the axis the rules give
   "embed") is all-gathered over it once a forward, and again in
   backward under ``remat``: the gathered shard's bytes each time.
2. In training, each gradient is reduce-scattered when its parameter is
   sharded over a batch axis, and all-reduced otherwise: the shard's
   bytes.
3. An LM whose rules split "heads" and "mlp" over "model" all-reduces
   the block's activation twice a layer ([B, S, d] in the model's dtype,
   S = 1 in decode, sharded as ``lm_act``), and twice that in training.
4. With experts sharded, each MoE layer runs two all-to-alls of its
   ``moe_buf4`` buffer (dispatch and combine, sharded as the policy
   says), and twice that in training.
5. A GNN all-gathers each layer's node states (the ``nodes``/``nodes3``
   record; dimenet's blocks record their edge states, ``edges``, which
   the triplet gather reads): the whole record's bytes, and in training
   a reduce-scatter of the same bytes in backward.
6. A sequence-sharded decode (B = 1, the KV cache over all axes)
   all-reduces the attention partials of each layer: o [B, H, D], m and
   l [B, H], float32.

Each record keeps the JAX package's keys; the HLO-only ones
(``hlo_instructions``, ``generated_code_bytes``, ``compile_s``) give way
to ``trace_s``. ``--keep-hlo`` writes the trace's op list in place of
HLO text. With ``--mesh both`` a model cell is traced once and reckoned
for each mesh when its arguments' shapes agree on both.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import shapes_for
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.input_specs import build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.act_sharding import policy
from repro_torch.roofline.analysis import (
    H100,
    kernel_work,
    roofline_terms,
    useful_flops,
)

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "torch" \
    / "dryrun"

KINDS = ("all-gather", "all-reduce", "all-to-all", "reduce-scatter",
         "collective-permute")
_C10D_KIND = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
              "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
              "_allgather_base_": "all-gather", "allgather_": "all-gather",
              "allgather_into_tensor_coalesced_": "all-gather",
              "reduce_scatter_": "reduce-scatter",
              "_reduce_scatter_base_": "reduce-scatter",
              "reduce_scatter_tensor_coalesced_": "reduce-scatter"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "logsumexp", "cumsum", "prod", "var", "std",
               "linalg_vector_norm", "norm", "any", "all", "scatter_reduce",
               "scatter_add", "index_add", "_softmax", "_log_softmax",
               "sort", "topk"}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _Trace(TorchDispatchMode):
    """Sums each op's bytes and elementwise operations, records c10d
    collectives, and follows the live storage the ops create."""

    def __init__(self, arguments, keep_ops: bool = False):
        super().__init__()
        self.arg_ids = {id(t.untyped_storage()) for t in arguments}
        self.live = {}  # id of a storage -> its bytes
        self.current = self.peak = 0
        self.bytes = 0.0
        self.flops = 0.0  # elementwise and reductions
        self.coll = {"bytes": dict.fromkeys(KINDS, 0),
                     "counts": dict.fromkeys(KINDS, 0)}
        self.ops = [] if keep_ops else None

    def _free(self, key):
        self.current -= self.live.pop(key, 0)

    def _track(self, outs):
        # a storage's Python object lives as long as the storage (torch
        # preserves it), so its finalizer runs when the last tensor on it
        # dies, autograd's saved tensors included
        for t in outs:
            st = t.untyped_storage()
            if id(st) in self.arg_ids or id(st) in self.live:
                continue
            self.live[id(st)] = st.nbytes()
            self.current += self.live[id(st)]
            weakref.finalize(st, self._free, id(st))
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func.namespace == "c10d":
            kind = _C10D_KIND.get(name)
            if kind is not None:
                first = _tensors(args[0]) if args else []
                self.coll["bytes"][kind] += sum(map(_nbytes, first))
                self.coll["counts"][kind] += 1
        elif not (func.is_view or name in _NO_BYTES):
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            if torch.Tag.pointwise in func.tags:
                self.flops += sum(t.numel() for t in outs)
            elif name in _REDUCTIONS:
                self.flops += sum(t.numel() for t in ins[:1])
        self._track(outs)
        if self.ops is not None:
            self.ops.append(f"{func} " + " ".join(
                f"{str(t.dtype)[6:]}{list(t.shape)}" for t in outs))
        return out


@dataclasses.dataclass
class Trace:
    """What one run of a cell's step measured (module docstring)."""

    flops: float  # products + elementwise + kernels
    matmul_flops: float
    kernel_flops: float
    bytes: float
    temp_bytes: int  # peak live storage beyond the arguments
    output_bytes: int
    collectives: dict
    records: list  # (key, shape, dtype, spec) of the constrain calls
    kernel_calls: dict
    ops: list | None
    trace_s: float


def measure(cell, keep_ops: bool = False, args=None) -> Trace:
    """Run ``cell.fn`` once on ``args`` (the cell's ``meta`` arguments by
    default; real tensors on a device work the same) under the counters
    of the module docstring and the cell's activation policy."""
    args = cell.args if args is None else args
    leaves = [t for _, t, _ in arg_leaves(args, cell.in_specs)]
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, kernel_work() as kw, \
            policy(cell.mesh, cell.policy or {}) as pol, \
            _Trace(leaves, keep_ops) as tr:
        out = cell.fn(*args)
        held = [t.untyped_storage() for t in _tensors(out)]
        out_storage = {id(st): st.nbytes() for st in held
                       if id(st) in tr.live}
        del held
    del out
    dt = time.perf_counter() - t0
    coll = dict(tr.coll, total=sum(tr.coll["bytes"].values()))
    mm = float(fc.get_total_flops())
    return Trace(flops=mm + tr.flops + kw["flops"], matmul_flops=mm,
                 kernel_flops=kw["flops"], bytes=tr.bytes + kw["bytes"],
                 temp_bytes=int(tr.peak), output_bytes=int(
                     sum(out_storage.values())),
                 collectives=coll,
                 records=pol.log if cell.policy is not None else [],
                 kernel_calls=dict(kw["calls"]), ops=tr.ops, trace_s=dt)


# ------------------------------ per device ----------------------------------


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec, mesh) -> tuple:
    """One device's block of a ``shape`` array laid out by ``spec``: each
    dimension ceil-divided by the mesh axes that shard it."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(d) // math.prod(mesh.shape[a] for a in _axes(e)))
                 for d, e in zip(shape, spec))


def shard_bytes(shape, itemsize: int, spec, mesh) -> int:
    return math.prod(shard_shape(shape, spec, mesh)) * int(itemsize)


def arg_leaves(args, specs, prefix: str = ""):
    """[(path, tensor, spec)] of a cell's arguments and their specs: a
    model's parameters by name, an ``OptState``'s fields, a dict's keys,
    a graph batch's tensor fields, a tuple's items."""
    out = []
    if isinstance(args, torch.nn.Module):
        for name, p in args.named_parameters():
            out.append((prefix + name, p, specs[name]))
    elif isinstance(args, torch.Tensor):
        out.append((prefix.rstrip("/"), args, specs))
    elif isinstance(args, dict):
        for k in args:
            out += arg_leaves(args[k], specs[k], f"{prefix}{k}/")
    elif hasattr(args, "_fields"):  # a NamedTuple
        for k in args._fields:
            out += arg_leaves(getattr(args, k), getattr(specs, k),
                              f"{prefix}{k}/")
    elif dataclasses.is_dataclass(args):
        for f in dataclasses.fields(args):
            v = getattr(args, f.name)
            if v is not None and not isinstance(v, int):
                out += arg_leaves(v, getattr(specs, f.name),
                                  f"{prefix}{f.name}/")
    elif isinstance(args, (tuple, list)):
        for i, (a, s) in enumerate(zip(args, specs)):
            out += arg_leaves(a, s, f"{prefix}{i}/")
    else:
        raise TypeError(f"{prefix}: cannot flatten {type(args).__name__}")
    return out


def argument_bytes(cell) -> int:
    """Bytes of the arguments one device holds (exact)."""
    return sum(shard_bytes(t.shape, t.element_size(), s, cell.mesh)
               for _, t, s in arg_leaves(cell.args, cell.in_specs))


# --------------------------- reckoned collectives ---------------------------


def _spec_for(cell, key, ndim):
    spec = (cell.policy or {}).get(key)
    return spec.get(ndim) if isinstance(spec, dict) else spec


def reckon(cell, records) -> dict:
    """The collectives of a model cell on its mesh, by the rules of the
    module docstring, from its specs and its ``constrain`` records."""
    out = {"bytes": dict.fromkeys(KINDS, 0), "counts": dict.fromkeys(KINDS, 0)}

    def add(kind, nbytes, times=1):
        out["bytes"][kind] += int(nbytes) * times
        out["counts"][kind] += times

    cfg, mesh, mode = cell.cfg, cell.mesh, cell.mode
    train = mode == "train"
    rules = mesh_lib.param_rules_for(cfg, mesh) if cell.rules is None \
        else cell.rules
    bax = set(mesh_lib.batch_axes(mesh))
    fsdp = set(_axes(rules.get("embed")))
    remat = bool(getattr(cfg, "remat", False)) and cfg.family == "lm"
    pspecs = cell.in_specs[0]
    for name, p in cell.args[0].named_parameters():
        spec = pspecs[name]
        used = {a for e in spec for a in _axes(e)}
        # rule 1: FSDP gathers
        if used & fsdp:
            gathered = tuple(tuple(a for a in _axes(e) if a not in fsdp)
                             or None for e in spec)
            add("all-gather", shard_bytes(p.shape, p.element_size(),
                                          gathered, mesh),
                1 + int(train and remat))
        # rule 2: gradients
        if train:
            add("reduce-scatter" if used & bax else "all-reduce",
                shard_bytes(p.shape, p.element_size(), spec, mesh))

    if cfg.family == "lm":
        b = cell.shape.d("global_batch")
        s = 1 if mode == "decode" else cell.shape.d("seq_len")
        itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        # rule 3: tensor-parallel all-reduces of the block's activation
        if rules.get("heads") == "model" and rules.get("mlp") == "model":
            act = shard_bytes((b, s, cfg.d_model), itemsize,
                              _spec_for(cell, "lm_act", 3), mesh)
            add("all-reduce", act, 2 * cfg.n_layers * (2 if train else 1))
        # rule 4: expert all-to-alls
        if cfg.moe is not None and rules.get("experts") is not None:
            buf = next(r for r in records if r[0] == "moe_buf4")
            nb = shard_bytes(buf[1], buf[2].itemsize,
                             _spec_for(cell, "moe_buf4", 4), mesh)
            n_moe = cfg.n_layers - cfg.moe.first_dense
            add("all-to-all", nb, 2 * n_moe * (2 if train else 1))
        # rule 6: sequence-sharded decode
        if mode == "decode" and b == 1:
            add("all-reduce", b * cfg.n_heads * (cfg.hd + 2) * 4,
                cfg.n_layers)
    elif cfg.family == "gnn":
        keys = {"nodes", "nodes3"} if cfg.kind != "dimenet" else {"edges"}
        # rule 5: node states gathered, reduce-scattered in backward
        for key, shape, dtype, _ in records:
            if key in keys:
                nb = math.prod(shape) * dtype.itemsize
                add("all-gather", nb)
                if train:
                    add("reduce-scatter", nb)
    out["total"] = sum(out["bytes"].values())
    return out


# --------------------------------- records ----------------------------------


def _record(cell, tr: Trace, chips: int) -> dict:
    cfg = cell.cfg
    one_rank = cfg.family == "matching"
    share = 1 if one_rank else chips
    coll = tr.collectives if one_rank else reckon(cell, tr.records)
    flops = tr.flops / share
    nbytes = tr.bytes / share
    temp = tr.temp_bytes // share
    arg_b = argument_bytes(cell)
    rl = roofline_terms(flops, nbytes, coll["total"], hw=H100)
    mf = useful_flops(cell.arch, cell.shape_name, cell.mode, cfg, cell.shape)
    note = cell.note
    if not one_rank:
        note = (note + "; " if note else "") + (
            "per-device FLOPs, bytes and temp: the global trace over the "
            "chips (even-sharding estimate); collectives reckoned from the "
            "specs")
    return dict(
        ok=True, mode=cell.mode, note=note,
        peak_memory_per_device=int(arg_b + temp),
        argument_bytes=int(arg_b),
        output_bytes=int(tr.output_bytes // share),
        temp_bytes=int(temp),
        flops_per_device=flops,
        bytes_per_device=nbytes,
        collectives=coll,
        roofline=rl.to_dict(),
        model_flops_global=mf,
        model_flops_ratio=(mf / (flops * chips) if flops else None),
        trace_s=round(tr.trace_s, 2),
    )


def _signature(cell):
    return tuple((p, tuple(t.shape), t.dtype)
                 for p, t, _ in arg_leaves(cell.args, cell.in_specs))


def run_cell(arch: str, shape_name: str, mesh_kind: str, router=None,
             keep_hlo: bool = False, variants: tuple = (),
             traces: dict | None = None, results=None) -> dict:
    """Build, trace and record one cell. ``traces`` (a dict) shares a
    model cell's trace between meshes whose arguments agree in shape."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.size
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": int(chips), "router": router or "default",
           "variants": list(variants), "ok": False}
    t0 = time.perf_counter()
    try:
        cell = build_cell(arch, shape_name, mesh, router=router,
                          variants=variants)
        key = None
        if cell.cfg.family != "matching" and traces is not None:
            key = (arch, shape_name, router, tuple(variants),
                   _signature(cell))
        tr = traces.get(key) if key is not None else None
        if tr is None:
            tr = measure(cell, keep_ops=keep_hlo)
            if key is not None:
                traces[key] = tr
        rec.update(_record(cell, tr, chips))
        if keep_hlo and tr.ops is not None:
            out = pathlib.Path(results or RESULTS)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"{arch}__{shape_name}__{mesh_kind}.ops.txt").write_text(
                "\n".join(tr.ops))
    except Exception as e:  # noqa: BLE001 — recorded, not swallowed silently
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def save(rec: dict, suffix="", results=None):
    out = pathlib.Path(results or RESULTS)
    out.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
    (out / name).write_text(json.dumps(rec, indent=1))
    status = "OK " if rec.get("ok") else "FAIL"
    rl = rec.get("roofline", {})
    print(f"[{status}] {name} trace={rec.get('trace_s')}s "
          f"total={rec.get('total_s')}s dominant={rl.get('dominant')} "
          f"peakMB={rec.get('peak_memory_per_device', 0) // 2**20}"
          + ("" if rec.get("ok") else f" err={rec.get('error')}"),
          flush=True)
    return rec.get("ok", False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--router", default=None)
    ap.add_argument("--variants", default="",
                    help="comma-separated: fsdp_gather,moe_ep,packed_a2a,"
                         "escn_sub,loss_chunk,gnn_bf16")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--keep-hlo", action="store_true",
                    help="write each trace's op list beside its record")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        targets = [(a, s.name) for a in ALL_ARCHS
                   for s in shapes_for(get_config(a))]
    elif args.arch and not args.shape:
        targets = [(args.arch, s.name)
                   for s in shapes_for(get_config(args.arch))]
    else:
        assert args.arch and args.shape, "--arch [--shape] or --all"
        targets = [(args.arch, args.shape)]

    variants = tuple(v for v in args.variants.split(",") if v)
    n_fail = 0
    for arch, shape in targets:
        traces = {}
        for mk in meshes:
            suffix = f"__{args.router}" if args.router else ""
            if variants:
                suffix += "__v_" + "_".join(variants)
            out = RESULTS / f"{arch}__{shape}__{mk}{suffix}.json"
            if args.skip_existing and out.exists() \
                    and json.loads(out.read_text()).get("ok"):
                print(f"[skip] {out.name}", flush=True)
                continue
            rec = run_cell(arch, shape, mk, router=args.router,
                           keep_hlo=args.keep_hlo, variants=variants,
                           traces=traces)
            if not save(rec, suffix):
                n_fail += 1
    print(f"done; failures: {n_fail}", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
