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
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, LMConfig, MoECfg, RecSysConfig

ATTENTION_IMPL = {"xla": "torch", "pallas": "cuda"}

_FFN = ("gate", "up", "down")


def _block_leaves(cfg, moe_layer: bool) -> dict[str, tuple[str, bool]]:
    """JAX leaf of a block (below its group) -> the port's parameter, and
    whether it is a dense weight to transpose."""
    leaves = {
        "ln1/scale": ("ln1.scale", False),
        "ln2/scale": ("ln2.scale", False),
        **{f"attn/{p}/w": (f"attn.{p}.weight", True) for p in "qkvo"},
    }
    if cfg.qkv_bias:
        leaves.update({f"attn/{p}/b": (f"attn.{p}.bias", False)
                       for p in "qkv"})
    if not moe_layer:
        leaves.update({f"ffn/{p}/w": (f"ffn.{p}.weight", True) for p in _FFN})
        return leaves
    md = cfg.moe
    leaves["ffn/router/w"] = ("ffn.router.weight", True)
    # [E, in, out] in both layouts (``moe.Experts``): no transpose
    leaves.update({f"ffn/experts/{p}": (f"ffn.experts.{p}", False)
                   for p in _FFN})
    if md.n_shared:
        leaves.update({f"ffn/shared/{p}/w": (f"ffn.shared.{p}.weight", True)
                       for p in _FFN})
        if md.shared_gate:
            leaves["ffn/shared_gate/w"] = ("ffn.shared_gate.weight", True)
    return leaves


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
    """(JAX leaf, the port's parameter, the layers stacked on the leaf's
    leading axis or None, whether it is a dense weight to transpose) of
    ``lm_def``'s tree; a stacked leaf's parameter name takes the layer
    index at ``{}``."""
    yield "embed", "embed", None, False
    for group, n_layers, moe_layer in _groups(cfg):
        for leaf, (name, transpose) in _block_leaves(cfg, moe_layer).items():
            yield f"{group}/{leaf}", f"{group}.{{}}.{name}", n_layers, transpose
    yield "final_norm/scale", "final_norm.scale", None, False
    if not cfg.tie_embeddings:
        yield "lm_head/w", "lm_head.weight", None, True


def _map_lm(params, cfg, convert) -> dict:
    """{the port's parameter: convert(array, transpose)} over the JAX tree
    of ``lm_def``, each stacked leaf split by layer."""
    take, refuse = _taker(params)
    out = {}
    for key, name, n_layers, transpose in _lm_entries(cfg):
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
    **{f"{n}/{p}": (f"{n}.{p}", False) for n in ("ln1", "ln2")
       for p in ("scale", "bias")},
    **{f"{n}/w": (f"{n}.weight", True) for n in
       ("q", "k", "v", "o", "ffn/up", "ffn/down")},
    **{f"{n}/b": (f"{n}.bias", False) for n in
       ("q", "k", "v", "o", "ffn/up", "ffn/down")},
}


def bert4rec_state_dict_from_jax(params, cfg) -> dict[str, torch.Tensor]:
    """The port's ``Bert4Rec`` state dict from the JAX parameter tree of
    ``bert4rec_def`` (numpy arrays)."""
    take, refuse = _taker(params)
    out = {name: _tensor(take(name)) for name in ("items", "pos",
                                                  "out_bias")}
    for i in range(cfg.n_blocks):
        for leaf, (name, transpose) in _BERT4REC_BLOCK.items():
            out[f"blocks.{i}.{name.replace('/', '.')}"] = _tensor(
                take(f"blocks/{i}/{leaf}"), transpose)
    for p in ("scale", "bias"):
        out[f"final_ln.{p}"] = _tensor(take(f"final_ln/{p}"))
    refuse()
    return out


def gnn_config_from_jax(fields: Mapping) -> GNNConfig:
    """A ``GNNConfig`` from the fields of the JAX package's ``GNNConfig``
    (``dataclasses.asdict``; ``extra`` may come back from JSON as lists)."""
    kw = dict(fields)
    kw["extra"] = tuple((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in kw.get("extra", ()))
    return GNNConfig(**kw)


def _dense(path: str, bias: bool) -> dict[str, tuple[str, bool]]:
    name = path.replace("/", ".")
    out = {f"{path}/w": (f"{name}.weight", True)}
    if bias:
        out[f"{path}/b"] = (f"{name}.bias", False)
    return out


def _mlp2(path: str) -> dict[str, tuple[str, bool]]:
    return {**_dense(f"{path}/l1", True), **_dense(f"{path}/l2", True)}


def _raw(path: str) -> dict[str, tuple[str, bool]]:
    return {path: (path.replace("/", "."), False)}


def _gnn_leaves(cfg) -> dict[str, tuple[str, bool]]:
    """JAX leaf -> (the port's parameter, whether to transpose) for the
    tree of ``cfg``'s GNN."""
    n = range(cfg.n_layers)
    if cfg.kind == "graphsage":
        out = {}
        for i in n:
            out.update(_dense(f"layers/{i}/self", True))
            out.update(_dense(f"layers/{i}/neigh", False))
        return {**out, **_dense("out", True)}
    if cfg.kind == "dimenet":
        out = {**_dense("embed_node", True), **_dense("embed_edge", True)}
        for i in n:
            b = f"blocks/{i}"
            out.update({**_mlp2(f"{b}/msg"), **_dense(f"{b}/rbf_proj", False),
                        **_dense(f"{b}/sbf_proj", False),
                        **_raw(f"{b}/bilinear"), **_mlp2(f"{b}/update"),
                        **_mlp2(f"{b}/out")})
        return out
    if cfg.kind == "equiformer_v2":
        out = {**_dense("embed", True), **_mlp2("head")}
        for i in n:
            b = f"layers/{i}"
            out.update({**_mlp2(f"{b}/inv_mlp"), **_dense(f"{b}/attn", True),
                        **_raw(f"{b}/mix"), **_dense(f"{b}/rad_scale", False),
                        **_dense(f"{b}/sh_inject", False),
                        **_dense(f"{b}/gate", True),
                        **_raw(f"{b}/norm_scale")})
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


def gnn_state_dict_from_jax(params, cfg) -> dict[str, torch.Tensor]:
    """The port's GNN state dict (``models.gnn``) from the JAX parameter
    tree of ``cfg``'s GNN (numpy arrays)."""
    take, refuse = _taker(params)
    out = {name: _tensor(take(key), transpose)
           for key, (name, transpose) in _gnn_leaves(cfg).items()}
    refuse()
    return out
