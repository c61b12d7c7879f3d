"""Carry the JAX package's LM and bert4rec weights and configs across to
the port.

``state_dict_from_jax`` turns the JAX parameter tree of ``lm_def`` (numpy
arrays; each block parameter stacked along a leading layer axis, as
``transformer.stack_defs`` makes it) into the state dict of
``transformer.LM``: it unstacks the layers of each block group
(``blocks``, or ``dense_blocks`` and ``moe_blocks``) and transposes each
dense weight from JAX's [in, out] to ``nn.Linear``'s [out, in]. The
stacked expert weights are [E, in, out] on both sides and are not
transposed. It raises on a leaf it does not consume (``moe_def`` gives the
shared gate no bias, and neither does the port) and on one it lacks.
``config_from_jax`` copies an ``LMConfig``'s fields and maps
``attention_impl`` "xla" / "pallas" to "torch" / "cuda".
``param_shapes_from_jax`` maps the shapes of JAX's tree (its
``abstract_params``) through the same names, for a full-size model that
is never materialised.

``bert4rec_state_dict_from_jax`` does the same for the tree of
``bert4rec_def``, whose blocks are a list (not stacked): ``items``,
``pos``, ``blocks/<i>/{ln1,q,k,v,o,ln2,ffn/up,ffn/down}``, ``final_ln``
and ``out_bias``, each dense weight transposed; it too raises on a leaf
left over or missing. ``recsys_config_from_jax`` copies a
``RecSysConfig``'s fields.

``gnn_state_dict_from_jax`` takes the trees of ``graphsage_def``,
``dimenet_def``, ``equiformer_def`` and ``graphcast_def`` (layer lists,
not stacked). A JAX path ``a/<i>/b/w`` is the port's ``a.<i>.b.weight``,
transposed from [in, out] to [out, in]; ``b`` is ``bias``; the raw
tensors ``bilinear`` [n_bil, d, d], ``mix`` [n_l, c, c] and
``norm_scale`` [n_l, c] keep their layout. It raises on a leaf left over
or missing. ``gnn_config_from_jax`` copies a ``GNNConfig``'s fields.

Each entry of these name maps also carries the JAX leaf's logical axis
names (its ``ParamDef.axes``); ``logical_axes`` gives them per parameter
of the port, in the port's layout, for ``models.param.partition_specs``.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, LMConfig, MoECfg, RecSysConfig

ATTENTION_IMPL = {"xla": "torch", "pallas": "cuda"}

class Leaf(NamedTuple):
    """The port's parameter of a JAX leaf, whether it is a dense weight to
    transpose from [in, out] to [out, in], and the logical axis names of
    the JAX leaf (its ``ParamDef.axes``, in JAX's layout)."""

    name: str
    transpose: bool
    axes: tuple


def _block_leaves(cfg, moe_layer: bool) -> dict[str, Leaf]:
    """JAX leaf of a block (below its group) -> its ``Leaf``."""
    kv = ("embed", "kv_heads")
    leaves = {
        "ln1/scale": Leaf("ln1.scale", False, ("embed",)),
        "ln2/scale": Leaf("ln2.scale", False, ("embed",)),
        "attn/q/w": Leaf("attn.q.weight", True, ("embed", "heads")),
        "attn/k/w": Leaf("attn.k.weight", True, kv),
        "attn/v/w": Leaf("attn.v.weight", True, kv),
        "attn/o/w": Leaf("attn.o.weight", True, ("heads", "embed")),
    }
    if cfg.qkv_bias:
        leaves.update({f"attn/{p}/b": Leaf(f"attn.{p}.bias", False, (ax,))
                       for p, ax in (("q", "heads"), ("k", "kv_heads"),
                                     ("v", "kv_heads"))})
    if not moe_layer:
        leaves.update(_swiglu("ffn"))
        return leaves
    md = cfg.moe
    leaves["ffn/router/w"] = Leaf("ffn.router.weight", True, ("embed", None))
    # [E, in, out] in both layouts (``moe.Experts``): no transpose
    leaves.update({
        f"ffn/experts/{p}": Leaf(f"ffn.experts.{p}", False, axes)
        for p, axes in (("gate", ("experts", "embed", "expert_mlp")),
                        ("up", ("experts", "embed", "expert_mlp")),
                        ("down", ("experts", "expert_mlp", "embed")))})
    if md.n_shared:
        leaves.update(_swiglu("ffn/shared"))
        if md.shared_gate:
            leaves["ffn/shared_gate/w"] = Leaf("ffn.shared_gate.weight", True,
                                               ("embed", None))
    return leaves


def _swiglu(path: str) -> dict[str, Leaf]:
    """The leaves of ``mlp_def`` at ``path``: gate and up ("embed",
    "mlp"), down ("mlp", "embed"), no biases."""
    name = path.replace("/", ".")
    return {f"{path}/{p}/w": Leaf(f"{name}.{p}.weight", True, axes)
            for p, axes in (("gate", ("embed", "mlp")),
                            ("up", ("embed", "mlp")),
                            ("down", ("mlp", "embed")))}


def _groups(cfg) -> list[tuple[str, int, bool]]:
    """(group, layers, moe_layer) of ``cfg``'s block groups."""
    if cfg.moe is None:
        return [("blocks", cfg.n_layers, False)]
    fd = cfg.moe.first_dense
    return ([("dense_blocks", fd, False)] if fd else []) + [
        ("moe_blocks", cfg.n_layers - fd, True)]


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested mapping (or list) of arrays -> {"a/b/c": array}, a list's
    items keyed by their index; a flat mapping with such keys passes
    through."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    out = {}
    for key, val in items:
        path = f"{prefix}{key}"
        if isinstance(val, (Mapping, list, tuple)):
            out.update(flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


def config_from_jax(fields: Mapping) -> LMConfig:
    """An ``LMConfig`` from the fields of the JAX package's ``LMConfig``
    (``dataclasses.asdict``)."""
    kw = dict(fields)
    kw["attention_impl"] = ATTENTION_IMPL[kw.get("attention_impl", "xla")]
    if kw.get("moe") is not None:
        kw["moe"] = MoECfg(**kw["moe"])
    return LMConfig(**kw)


def _taker(params):
    """(take, refuse) over the flattened tree: ``take(key)`` returns a leaf
    and marks it consumed; ``refuse()`` raises on the leaves not taken."""
    flat = flatten(params)
    used = set()

    def take(key):
        if key not in flat:
            raise KeyError(f"the JAX tree lacks {key!r}")
        used.add(key)
        return flat[key]

    def refuse():
        left = sorted(set(flat) - used)
        if left:
            raise ValueError(f"JAX leaves the port does not consume: {left}")

    return take, refuse


def _tensor(w: np.ndarray, transpose: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.T if transpose else w))


def _lm_entries(cfg):
    """(JAX leaf, the layers stacked on the leaf's leading axis or None,
    its ``Leaf``) of ``lm_def``'s tree; a stacked leaf's parameter name
    takes the layer index at ``{}``, and its axes are one layer's."""
    yield "embed", None, Leaf("embed", False, ("vocab", "embed"))
    for group, n_layers, moe_layer in _groups(cfg):
        for key, leaf in _block_leaves(cfg, moe_layer).items():
            yield (f"{group}/{key}", n_layers,
                   leaf._replace(name=f"{group}.{{}}.{leaf.name}"))
    yield "final_norm/scale", None, Leaf("final_norm.scale", False,
                                         ("embed",))
    if not cfg.tie_embeddings:
        yield "lm_head/w", None, Leaf("lm_head.weight", True,
                                      ("embed", "vocab"))


def _map_lm(params, cfg, convert) -> dict:
    """{the port's parameter: convert(array, transpose)} over the JAX tree
    of ``lm_def``, each stacked leaf split by layer."""
    take, refuse = _taker(params)
    out = {}
    for key, n_layers, (name, transpose, _) in _lm_entries(cfg):
        leaf = take(key)
        if n_layers is None:
            out[name] = convert(leaf, transpose)
            continue
        if leaf.shape[0] != n_layers:
            raise ValueError(f"{key}: {leaf.shape[0]} layers stacked, "
                             f"the config has {n_layers}")
        for i in range(n_layers):
            out[name.format(i)] = convert(leaf[i], transpose)
    refuse()
    return out


def state_dict_from_jax(params, cfg) -> dict[str, torch.Tensor]:
    """The port's ``LM`` state dict from the JAX parameter tree."""
    return _map_lm(params, cfg, _tensor)


def param_shapes_from_jax(shapes, cfg) -> dict[str, tuple[int, ...]]:
    """The shape of each of the port's ``LM`` parameters, from the shapes
    of the JAX parameter tree ({path: shape}, as JAX's
    ``abstract_params`` gives them), through the name map of
    ``state_dict_from_jax``. Nothing of the model's size is allocated."""
    def stand_in(shape):  # an array of that shape in no memory
        return np.broadcast_to(np.zeros((), np.float32), tuple(shape))

    return _map_lm({k: stand_in(v) for k, v in shapes.items()}, cfg,
                   lambda a, t: tuple(a.T.shape if t else a.shape))


def recsys_config_from_jax(fields: Mapping) -> RecSysConfig:
    """A ``RecSysConfig`` from the fields of the JAX package's
    ``RecSysConfig`` (``dataclasses.asdict``)."""
    return RecSysConfig(**fields)


_BERT4REC_BLOCK = {
    **{f"{n}/{p}": Leaf(f"{n}.{p}", False, ("embed",))
       for n in ("ln1", "ln2") for p in ("scale", "bias")},
    **{f"{n}/w": Leaf(f"{n}.weight", True, ("embed", "heads"))
       for n in ("q", "k", "v")},
    **{f"{n}/b": Leaf(f"{n}.bias", False, ("heads",)) for n in ("q", "k", "v")},
    "o/w": Leaf("o.weight", True, ("heads", "embed")),
    "o/b": Leaf("o.bias", False, ("embed",)),
    "ffn/up/w": Leaf("ffn.up.weight", True, ("embed", "mlp")),
    "ffn/up/b": Leaf("ffn.up.bias", False, ("mlp",)),
    "ffn/down/w": Leaf("ffn.down.weight", True, ("mlp", "embed")),
    "ffn/down/b": Leaf("ffn.down.bias", False, ("embed",)),
}


def _bert4rec_leaves(cfg) -> dict[str, Leaf]:
    """JAX leaf -> ``Leaf`` for the tree of ``bert4rec_def``."""
    out = {"items": Leaf("items", False, ("vocab", "embed")),
           "pos": Leaf("pos", False, (None, "embed")),
           "out_bias": Leaf("out_bias", False, ("vocab",))}
    for i in range(cfg.n_blocks):
        out.update({f"blocks/{i}/{key}": leaf._replace(
            name=f"blocks.{i}.{leaf.name}")
            for key, leaf in _BERT4REC_BLOCK.items()})
    out.update({f"final_ln/{p}": Leaf(f"final_ln.{p}", False, ("embed",))
                for p in ("scale", "bias")})
    return out


def bert4rec_state_dict_from_jax(params, cfg) -> dict[str, torch.Tensor]:
    """The port's ``Bert4Rec`` state dict from the JAX parameter tree of
    ``bert4rec_def`` (numpy arrays)."""
    take, refuse = _taker(params)
    out = {leaf.name: _tensor(take(key), leaf.transpose)
           for key, leaf in _bert4rec_leaves(cfg).items()}
    refuse()
    return out


def gnn_config_from_jax(fields: Mapping) -> GNNConfig:
    """A ``GNNConfig`` from the fields of the JAX package's ``GNNConfig``
    (``dataclasses.asdict``; ``extra`` may come back from JSON as lists)."""
    kw = dict(fields)
    kw["extra"] = tuple((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in kw.get("extra", ()))
    return GNNConfig(**kw)


def _dense(path: str, axes, bias_axis=False) -> dict[str, Leaf]:
    """``dense_def`` at ``path`` with weight ``axes``, and a bias on
    ``bias_axis`` unless it is False (None is a replicated bias)."""
    name = path.replace("/", ".")
    out = {f"{path}/w": Leaf(f"{name}.weight", True, axes)}
    if bias_axis is not False:
        out[f"{path}/b"] = Leaf(f"{name}.bias", False, (bias_axis,))
    return out


def _mlp2(path: str) -> dict[str, Leaf]:
    """``mlp2_def`` at ``path``, with its default axes."""
    return {**_dense(f"{path}/l1", ("embed", "mlp"), "mlp"),
            **_dense(f"{path}/l2", ("mlp", "embed"), "embed")}


def _raw(path: str, axes) -> dict[str, Leaf]:
    return {path: Leaf(path.replace("/", "."), False, axes)}


def _gnn_leaves(cfg) -> dict[str, Leaf]:
    """JAX leaf -> ``Leaf`` for the tree of ``cfg``'s GNN."""
    n = range(cfg.n_layers)
    em = ("embed", "mlp")
    if cfg.kind == "graphsage":
        out = {}
        for i in n:
            out.update(_dense(f"layers/{i}/self", em, "mlp"))
            out.update(_dense(f"layers/{i}/neigh", em))
        return {**out, **_dense("out", ("mlp", None), None)}
    if cfg.kind == "dimenet":
        out = {**_dense("embed_node", em, "mlp"),
               **_dense("embed_edge", (None, "mlp"), "mlp")}
        for i in n:
            b = f"blocks/{i}"
            out.update({**_mlp2(f"{b}/msg"),
                        **_dense(f"{b}/rbf_proj", (None, "mlp")),
                        **_dense(f"{b}/sbf_proj", (None, None)),
                        **_raw(f"{b}/bilinear", (None, "embed", "mlp")),
                        **_mlp2(f"{b}/update"), **_mlp2(f"{b}/out")})
        return out
    if cfg.kind == "equiformer_v2":
        out = {**_dense("embed", em, "mlp"), **_mlp2("head")}
        for i in n:
            b = f"layers/{i}"
            out.update({**_mlp2(f"{b}/inv_mlp"),
                        **_dense(f"{b}/attn", ("mlp", None), None),
                        **_raw(f"{b}/mix", (None, "embed", "mlp")),
                        **_dense(f"{b}/rad_scale", ("mlp", None)),
                        **_dense(f"{b}/sh_inject", em),
                        **_dense(f"{b}/gate", em, None),
                        **_raw(f"{b}/norm_scale", (None, None))})
        return out
    if cfg.kind == "graphcast":
        out = {}
        for name in ("grid_embed", "g2m_edge", "mesh_node_enc", "m2g_edge",
                     "grid_dec"):
            out.update(_mlp2(name))
        for i in n:
            out.update({**_mlp2(f"proc/{i}/edge"), **_mlp2(f"proc/{i}/node")})
        return out
    raise ValueError(f"unknown GNN kind {cfg.kind!r}")


def logical_axes(cfg) -> dict[str, tuple]:
    """The logical axis names of each of the port's parameters of
    ``cfg``'s model, in the port's layout: the JAX leaf's ``ParamDef``
    axes through the name map above, reversed where the weight is
    transposed, one layer's axes for each layer of a stacked leaf."""
    if cfg.family == "lm":
        entries = [(n_layers, leaf) for _, n_layers, leaf in _lm_entries(cfg)]
    elif cfg.family == "recsys":
        entries = [(None, leaf) for leaf in _bert4rec_leaves(cfg).values()]
    elif cfg.family == "gnn":
        entries = [(None, leaf) for leaf in _gnn_leaves(cfg).values()]
    else:
        raise ValueError(f"{cfg.family!r} has no parameters")
    out = {}
    for n_layers, (name, transpose, axes) in entries:
        axes = tuple(reversed(axes)) if transpose else tuple(axes)
        for i in range(n_layers or 1):
            out[name.format(i) if n_layers else name] = axes
    return out


def gnn_state_dict_from_jax(params, cfg) -> dict[str, torch.Tensor]:
    """The port's GNN state dict (``models.gnn``) from the JAX parameter
    tree of ``cfg``'s GNN (numpy arrays)."""
    take, refuse = _taker(params)
    out = {leaf.name: _tensor(take(key), leaf.transpose)
           for key, leaf in _gnn_leaves(cfg).items()}
    refuse()
    return out
