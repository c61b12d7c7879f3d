"""The port's GNN family against the JAX package, on the CPU, at smoke
size: graphsage-reddit, dimenet, equiformer-v2 (also with
``escn_subspace``) and graphcast at ``reduced()`` on the graphs of the
JAX package's ``tests/test_configs_smoke.py`` (a single graph for the
``full_graph_sm`` cell, four small graphs for ``molecule``; 8 features):
the loss, every gradient leaf, and the parameters after 3 AdamW steps
with clipping and the schedule in effect; graphsage on sampled blocks;
graphsage's masked loss; the configs, the launcher for each GNN arch and
the weight converter's refusals. The card tests (marker ``gpu``) hold
each model on the card to the CPU.

The JAX side runs once in a child process
(``test_torch_harness.run_reference``), with its weights drawn from
``PRNGKey(0)`` and carried across with ``models.convert``; both sides
draw their graphs from their own copy of ``data/graphs.py`` at the same
seeds (``test_torch_gnn_data.py`` holds the copies equal). Tolerances:
the loss within 1e-5 relative, each gradient leaf within 1e-4 of that
leaf's largest magnitude, and after the AdamW steps each parameter entry
within 1e-4 of its leaf's largest magnitude plus the slack of
``test_torch_training._steps`` (float32 sums in other orders).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import GNNConfig, ShapeSpec, gnn_shape  # noqa: E402
from repro_torch.data import graphs as G  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build_defs, build_loss, gnn_module  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    gnn_config_from_jax,
    gnn_state_dict_from_jax,
)
from repro_torch.models.gnn.common import GraphBatch  # noqa: E402
from repro_torch.models.gnn.sampler import build_csr, sample_blocks  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    init_opt_state,
    make_train_step,
)
from repro_torch.training.loop import loss_and_grads, to_device  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

ARCHS = ("graphsage-reddit", "dimenet", "equiformer-v2", "graphcast")
# name -> (arch, shape cell, extra config options)
CASES = {f"{arch}@{shape}": (arch, shape, ())
         for arch in ARCHS for shape in ("full_graph_sm", "molecule")}
CASES["equiformer-v2@molecule+escn"] = ("equiformer-v2", "molecule",
                                       (("escn_subspace", True),))
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
STEPS = 3
TOL = 1e-4  # of a leaf's largest magnitude
LOSS_TOL = 1e-5  # relative
# float32 rounding noise of a gradient entry, as a share of its leaf's
# largest magnitude (test_torch_training.GRAD_NOISE)
GRAD_NOISE = 1e-5
# equiformer-v2's ``near_zero_leaves`` have gradients of the order of
# float32 rounding: each is held to JAX as a difference of at most this
# share of the model's largest gradient
ZERO_TOL = 1e-6


def near_zero_leaves(model, cfg) -> set:
    """``equiformer_v2.near_zero_leaves`` for an equiformer-v2, none for
    the other archs. AdamW, which scales each entry's gradient to a step
    of about lr, steps those leaves by rounding noise, and two runs of a
    few steps part ways: those cases take each step from JAX's
    parameters of the step before (``test_three_adamw_steps_match_jax``)."""
    if cfg.kind != "equiformer_v2":
        return set()
    return gnn_module("equiformer_v2").near_zero_leaves(model)


# The graphs of the cases, as source run on each side against that side's
# own ``data/graphs.py``, sampler and ``GraphBatch`` (bound to ``G``,
# ``build_csr``, ``sample_blocks`` and ``GraphBatch``): numpy only.
RECIPES = """
def case_batch(arch, shape, step):
    # the recipe of tests/test_configs_smoke.py::_gnn_batch at seed step
    if arch == "graphcast":
        return G.random_graphcast_batch(120, 12, seed=step)
    coords = arch in ("dimenet", "equiformer-v2")
    if shape == "molecule":
        return G.random_graph(60, 128, 8, seed=step, coords=coords,
                              n_graphs=4, triplets=arch == "dimenet")
    return G.random_graph(80, 240, 8, n_classes=7, seed=step, coords=coords,
                          triplets=arch == "dimenet")


def sampled_batch():
    # graphsage's sampled blocks (tests/test_configs_smoke.py:110-135)
    # and the count of their nodes
    rng = np.random.default_rng(0)
    n, e = 2000, 12000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    labels = rng.integers(0, 7, n).astype(np.int32)
    ptr, nbrs = build_csr(n, src, dst)
    blocks = sample_blocks(ptr, nbrs, rng.integers(0, n, 16), [5, 3], rng)
    return GraphBatch(node_feat=feats[blocks.node_ids],
                      edge_src=blocks.edge_src, edge_dst=blocks.edge_dst,
                      labels=labels[blocks.node_ids]), len(blocks.node_ids)


def masked(n):
    return (np.random.default_rng(9).random(n) < 0.5).astype(np.float32)
"""
_RECIPES_NS = dict(np=np, G=G, GraphBatch=GraphBatch, build_csr=build_csr,
                   sample_blocks=sample_blocks)
exec(RECIPES, _RECIPES_NS)
case_batch, sampled_batch, masked = (
    _RECIPES_NS[k] for k in ("case_batch", "sampled_batch", "masked"))


REFERENCE = """
import dataclasses
import json

import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.data import graphs as G
from repro.models import build_defs, build_loss
from repro.models.gnn import graphsage
from repro.models.gnn.common import GraphBatch
from repro.models.gnn.sampler import build_csr, sample_blocks
from repro.models.param import init_params
from repro.training.loop import make_train_step
from repro.training.optimizer import AdamWConfig, init_opt_state

exec(str(IN["recipes"]))


def flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def dev(gb):
    return jax.tree.map(jnp.asarray, gb)


opt = AdamWConfig(**json.loads(str(IN["opt"])))
for name, (arch, shape_name, extra) in json.loads(str(IN["cases"])).items():
    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, extra=cfg.extra + tuple(
        tuple(kv) for kv in extra))
    OUT[name + "__cfg"] = json.dumps(dataclasses.asdict(cfg))
    shape = ShapeSpec(shape_name, "train", (("d_feat", 8),))
    params = init_params(build_defs(cfg, shape), jax.random.PRNGKey(0))
    OUT.update(flat(params, name + "__p__"))
    loss_fn = build_loss(cfg)
    (loss, out), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, dev(case_batch(arch, shape_name, 0)))
    OUT[name + "__loss"], OUT[name + "__out"] = loss, out
    OUT.update(flat(g, name + "__g__"))
    step = jax.jit(make_train_step(loss_fn, opt))
    p, o = params, init_opt_state(params)
    metrics = []
    for s in range(int(IN["steps"])):
        p, o, m = step(p, o, dev(case_batch(arch, shape_name, s)))
        metrics.append([m["loss"], m["grad_norm"], m["lr"]])
        OUT.update(flat(p, f"{name}__p{s + 1}__"))
    OUT[name + "__metrics"] = np.array(metrics, np.float32)

# equiformer-v2 at full width and depth, whose gradient overflows in JAX
cfg = get_config("equiformer-v2")
OUT["deep__cfg"] = json.dumps(dataclasses.asdict(cfg))
shape = ShapeSpec("molecule", "train", (("d_feat", 8),))
params = init_params(build_defs(cfg, shape), jax.random.PRNGKey(0))
OUT.update(flat(params, "deep__p__"))
(loss, _), g = jax.jit(jax.value_and_grad(build_loss(cfg), has_aux=True))(
    params, dev(case_batch("equiformer-v2", "molecule", 0)))
OUT["deep__loss"] = loss
OUT.update(flat(g, "deep__g__"))

# graphsage on sampled blocks, and its masked loss
cfg = get_config("graphsage-reddit", reduced=True)
shape = ShapeSpec("minibatch_lg", "train", (("d_feat", 8),))
params = init_params(build_defs(cfg, shape), jax.random.PRNGKey(0))
OUT["sampled__cfg"] = json.dumps(dataclasses.asdict(cfg))
OUT.update(flat(params, "sampled__p__"))
gb, _ = sampled_batch()
(loss, logits), g = jax.value_and_grad(build_loss(cfg), has_aux=True)(
    params, dev(gb))
OUT["sampled__loss"], OUT["sampled__logits"] = loss, logits
OUT.update(flat(g, "sampled__g__"))
mask = masked(gb.node_feat.shape[0])
OUT["sampled__masked_loss"] = graphsage.loss_fn(params, dev(gb), cfg,
                                                jnp.asarray(mask))[0]
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = dict(cases=np.array(json.dumps(CASES)),
                  opt=np.array(json.dumps(OPT)), steps=np.array(STEPS),
                  recipes=np.array(RECIPES))
    return run_reference(REFERENCE, inputs, tmp_path_factory.mktemp("gnn"))


def _prefixed(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _port_model(ref, name, shape_name, prefix=None):
    """The port's model of a case with JAX's weights, and its config."""
    cfg = gnn_config_from_jax(json.loads(str(ref[name + "__cfg"])))
    shape = ShapeSpec(shape_name, "train", (("d_feat", 8),))
    model = build_defs(cfg, shape, device="cpu")
    model.load_state_dict(gnn_state_dict_from_jax(
        _prefixed(ref, f"{prefix or name}__p__"), cfg))
    return model, cfg


def _leaf_close(got: dict, want: dict, tol: float, what: str,
                near_zero=(), zero_scale=None):
    """Every leaf within ``tol`` of its largest magnitude; a leaf of
    ``near_zero`` within ``tol`` of ``zero_scale`` instead."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        w = w.numpy() if torch.is_tensor(w) else w
        scale = zero_scale if k in near_zero else max(
            float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, f"{what} {k}: {err:.3g} of its largest magnitude"


def _grads_close(ref, prefix, model, grads, cfg, what):
    want = gnn_state_dict_from_jax(_prefixed(ref, f"{prefix}__g__"), cfg)
    assert all(torch.isfinite(w).all() for w in want.values()), what
    zero = near_zero_leaves(model, cfg)
    largest = max(float(w.abs().max()) for w in want.values())
    for k in zero:  # the reference's own gradients there are that small
        assert float(want[k].abs().max()) <= 10 * ZERO_TOL * largest, k
    _leaf_close(grads, want, TOL, what, zero, ZERO_TOL / TOL * largest)


@pytest.mark.parametrize("name", CASES)
def test_loss_and_output_match_jax(ref, name):
    arch, shape_name, _ = CASES[name]
    model, cfg = _port_model(ref, name, shape_name)
    batch = to_device(case_batch(arch, shape_name, 0), "cpu")
    loss, out = build_loss(cfg)(model, batch)
    np.testing.assert_allclose(float(loss), float(ref[name + "__loss"]),
                               rtol=LOSS_TOL)
    want = ref[name + "__out"]
    assert tuple(out.shape) == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=TOL * scale)


@pytest.mark.parametrize("name", CASES)
def test_gradients_match_jax(ref, name):
    arch, shape_name, _ = CASES[name]
    model, cfg = _port_model(ref, name, shape_name)
    batch = to_device(case_batch(arch, shape_name, 0), "cpu")
    _, _, grads = loss_and_grads(build_loss(cfg), model, batch)
    _grads_close(ref, name, model, grads, cfg, f"{name} gradient")


def _steps(model, cfg, arch, shape_name, n, opt_cfg, restart=None):
    """``n`` train steps on the case's graphs: (metrics per step,
    {name: each entry's slack}), by ``test_torch_training._steps``'s
    rule: an entry whose gradient is a small share of its leaf's largest
    carries float32 noise (GRAD_NOISE of that largest) into its AdamW
    step in that ratio, capped at the two steps' difference of 2 lr; a
    leaf of ``near_zero_leaves`` steps by noise alone, on both sides.
    With ``restart`` (step -> state dict), each step starts from those
    parameters, and the slack is that of the last step alone."""
    loss_fn = build_loss(cfg)
    step = make_train_step(loss_fn, opt_cfg)
    opt = init_opt_state(model)
    zero = near_zero_leaves(model, cfg)
    metrics, slack = [], {}
    for s in range(n):
        if restart is not None:
            model.load_state_dict(restart(s))
            slack = {}
        batch = to_device(case_batch(arch, shape_name, s), "cpu")
        _, _, g = loss_and_grads(loss_fn, model, batch)
        model, opt, m = step(model, opt, batch)
        lr = float(m["lr"])
        largest = max(float(gk.abs().max()) for gk in g.values())
        for k, gk in g.items():
            # a leaf whose gradient is noise holds noise of the terms it
            # sums, which the model's largest gradient bounds
            top = largest if k in zero else float(gk.abs().max())
            noise = GRAD_NOISE * top
            share = (noise / gk.abs().clamp_min(1e-30)).clamp(max=2.0)
            slack[k] = slack.get(k, 0.0) + lr * share
        metrics.append([float(m["loss"]), float(m["grad_norm"]), lr])
    return np.array(metrics), slack


@pytest.mark.parametrize("name", CASES)
def test_three_adamw_steps_match_jax(ref, name):
    """3 AdamW steps: the loss, gradient norm and learning rate of each,
    and the parameters after them. A model with ``near_zero_leaves``
    takes each step from JAX's parameters of the step before."""
    arch, shape_name, _ = CASES[name]
    model, cfg = _port_model(ref, name, shape_name)
    restart = None
    if near_zero_leaves(model, cfg):
        def restart(s):
            return gnn_state_dict_from_jax(
                _prefixed(ref, f"{name}__p{s or ''}__"), cfg)
    metrics, slack = _steps(model, cfg, arch, shape_name, STEPS,
                            AdamWConfig(**OPT), restart)
    want = ref[name + "__metrics"]
    np.testing.assert_allclose(metrics[:, 0], want[:, 0], rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics[:, 1:], want[:, 1:], rtol=TOL)
    assert len(set(want[:, 2].tolist())) == STEPS  # the schedule moves
    p3 = gnn_state_dict_from_jax(_prefixed(ref, f"{name}__p3__"), cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(p3)
    for k, w in p3.items():
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        excess = np.abs(got[k].detach().numpy() - w) - slack[k].numpy()
        worst = float(excess.max()) / scale
        assert worst <= TOL, f"{name} {k} after {STEPS} steps: {worst:.3g} " \
                             f"of its largest magnitude beyond its slack"


def test_full_depth_equiformer_gradient_is_finite_where_jax_overflows(ref):
    """At 12 layers a node with no incoming edge carries its zero l > 0
    blocks through 12 per-degree norms, whose derivative there is 1e6:
    JAX's gradient overflows to inf and NaN (the embedding and layer 0's
    gate and norm_scale). The port cuts the gradient of exact-zero blocks
    (``equiformer_v2._normalize``): every leaf is finite, and every leaf
    that JAX gives finite agrees with it. At this depth the
    ``near_zero_leaves`` of the last layers take gradients of up to 1e-3
    of the largest through the norm's 1e-12 near a zero l = 0 entry,
    where float32 rounding of that entry moves them by a few percent:
    they are held within 1e-5 of the model's largest gradient."""
    model, cfg = _port_model(ref, "deep", "molecule")
    assert cfg.n_layers == 12
    batch = to_device(case_batch("equiformer-v2", "molecule", 0), "cpu")
    loss, _, grads = loss_and_grads(build_loss(cfg), model, batch)
    np.testing.assert_allclose(float(loss), float(ref["deep__loss"]),
                               rtol=LOSS_TOL)
    want = gnn_state_dict_from_jax(_prefixed(ref, "deep__g__"), cfg)
    overflow = {k for k, w in want.items() if not torch.isfinite(w).all()}
    # the embedding and the gates and norm scales that multiply the zero
    # blocks; how many layers overflow varies with the rounding of a run
    assert {"embed.weight", "embed.bias", "layers.0.gate.weight",
            "layers.0.gate.bias", "layers.0.norm_scale"} <= overflow
    assert all(k.startswith(("embed.", "layers.")) and (
        ".gate." in k or k.endswith("norm_scale") or k.startswith("embed."))
        for k in overflow), overflow
    assert all(torch.isfinite(g).all() for g in grads.values())
    finite = {k: w for k, w in want.items() if k not in overflow}
    largest = max(float(w.abs().max()) for w in finite.values())
    _leaf_close({k: grads[k] for k in finite}, finite, TOL,
                "full-depth gradient", near_zero_leaves(model, cfg),
                1e-5 / TOL * largest)


def test_sampled_blocks_match_jax(ref):
    model, cfg = _port_model(ref, "sampled", "minibatch_lg")
    gb, nt = sampled_batch()
    batch = to_device(gb, "cpu")
    loss, logits, grads = loss_and_grads(build_loss(cfg), model, batch)
    assert tuple(logits.shape) == (nt, 41) == ref["sampled__logits"].shape
    np.testing.assert_allclose(float(loss), float(ref["sampled__loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(
        logits.detach().numpy(), ref["sampled__logits"], rtol=0,
        atol=TOL * float(np.abs(ref["sampled__logits"]).max()))
    _grads_close(ref, "sampled", model, grads, cfg,
                 "sampled-blocks gradient")


def test_graphsage_masked_loss_matches_jax(ref):
    model, cfg = _port_model(ref, "sampled", "minibatch_lg")
    gb, _ = sampled_batch()
    batch = to_device(gb, "cpu")
    mask = torch.from_numpy(masked(gb.node_feat.shape[0]))
    loss, _ = gnn_module("graphsage").loss_fn(model, batch, cfg, mask)
    np.testing.assert_allclose(float(loss),
                               float(ref["sampled__masked_loss"]),
                               rtol=LOSS_TOL)
    unmasked, _ = build_loss(cfg)(model, batch)
    assert float(loss) != float(unmasked)


def test_full_configs_carry_the_published_fields():
    """``tests/test_configs_smoke.py:180-189``."""
    c = get_config("graphsage-reddit")
    assert (c.n_layers, c.d_hidden) == (2, 128)
    assert (c.opt("aggregator"), c.opt("sample_sizes")) == ("mean", (25, 10))
    c = get_config("equiformer-v2")
    assert (c.n_layers, c.d_hidden, c.opt("l_max"), c.opt("m_max"),
            c.opt("n_heads")) == (12, 128, 6, 2, 8)
    c = get_config("dimenet")
    assert (c.n_layers, c.d_hidden, c.opt("n_bilinear"), c.opt("n_spherical"),
            c.opt("n_radial")) == (6, 128, 8, 7, 6)
    c = get_config("graphcast")
    assert (c.n_layers, c.d_hidden, c.opt("n_vars")) == (16, 512, 227)
    for arch in ARCHS:
        for reduced in (False, True):
            cfg = get_config(arch, reduced=reduced)
            assert isinstance(cfg, GNNConfig) and cfg.family == "gnn"


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(ref, arch):
    """The reduced configs' fields equal the JAX package's."""
    name = f"{arch}@molecule"
    want = gnn_config_from_jax(json.loads(str(ref[name + "__cfg"])))
    assert get_config(arch, reduced=True) == want


def test_not_yet_holds_only_12d_and_the_matching_config():
    from repro_torch.configs import _NOT_YET

    assert set(_NOT_YET) == {"qwen2-7b", "qwen1.5-110b", "awpm-matching"}


def test_gnn_shape_cells():
    assert gnn_shape("minibatch_lg").d("d_feat") == 602
    assert gnn_shape("molecule").d("batch") == 128
    with pytest.raises(KeyError, match="unknown GNN shape"):
        gnn_shape("cora")


def test_build_defs_needs_the_shape_and_the_card():
    cfg = get_config("dimenet", reduced=True)
    with pytest.raises(ValueError, match="shape cell"):
        build_defs(cfg, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: build_defs() builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_defs(cfg, gnn_shape("molecule"))


def test_output_sizes_follow_the_shape_cell():
    for arch, shape, n_out in (("graphsage-reddit", "minibatch_lg", 41),
                               ("dimenet", "molecule", 1),
                               ("equiformer-v2", "ogb_products", 47)):
        cfg = get_config(arch, reduced=True)
        model = build_defs(cfg, gnn_shape(shape), device="cpu")
        d_feat = gnn_shape(shape).d("d_feat")
        first = next(model.parameters())
        assert first.shape[-1] == d_feat, arch
        last = [p for n, p in model.named_parameters()
                if n.endswith("weight")][-1]
        assert last.shape[0] == n_out, arch
    # graphcast ignores the cell: its width is the config's n_vars
    cfg = get_config("graphcast", reduced=True)
    model = build_defs(cfg, gnn_shape("minibatch_lg"), device="cpu")
    assert model.grid_dec.l2.weight.shape[0] == cfg.opt("n_vars")


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_each_gnn_arch(arch, capsys):
    hist = launcher.main(["--arch", arch, "--device", "cpu", "--steps", "2"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "final loss" in capsys.readouterr().out


def test_cli_refuses_grad_accum_for_a_graph_batch():
    with pytest.raises(ValueError, match="GraphBatch has none to cut"):
        launcher.main(["--arch", "graphsage-reddit", "--device", "cpu",
                       "--steps", "2", "--grad-accum", "2"])


def test_train_step_refuses_grad_accum_for_a_graph_batch():
    cfg = get_config("graphcast", reduced=True)
    model = build_defs(cfg, launcher.gnn_train_shape(), device="cpu")
    step = make_train_step(build_loss(cfg), AdamWConfig(), grad_accum=2)
    batch = to_device(launcher._data_fn(cfg, 1, 1)(0), "cpu")
    with pytest.raises(ValueError, match="GraphCastBatch"):
        step(model, init_opt_state(model), batch)


def test_to_device_carries_graph_batches():
    for arch in ("dimenet", "graphcast"):
        raw = case_batch(arch, "molecule", 0)
        batch = to_device(raw, "cpu")
        assert type(batch) is type(raw)
        for f in dataclasses.fields(raw):
            a, b = getattr(raw, f.name), getattr(batch, f.name)
            if f.name in ("n_graphs", "n_mesh"):
                assert a == b
            elif isinstance(a, tuple):
                for x, y in zip(a, b):
                    assert torch.is_tensor(y)
                    np.testing.assert_array_equal(x, y.numpy())
            elif a is not None:
                assert torch.is_tensor(b) and b.device.type == "cpu"
                np.testing.assert_array_equal(a, b.numpy())
        # a batch of tensors passes through unchanged in value
        again = to_device(batch, "cpu")
        assert type(again) is type(raw)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_converter_refuses_extra_and_missing_leaves(ref, arch):
    name = f"{arch}@molecule"
    cfg = gnn_config_from_jax(json.loads(str(ref[name + "__cfg"])))
    params = _prefixed(ref, f"{name}__p__")
    gnn_state_dict_from_jax(params, cfg)
    with pytest.raises(ValueError, match="does not consume"):
        gnn_state_dict_from_jax(dict(params, **{"extra/w": np.zeros(2)}),
                                cfg)
    gone = sorted(params)[0]
    del params[gone]
    with pytest.raises(KeyError, match=gone):
        gnn_state_dict_from_jax(params, cfg)


def test_dense_weights_are_transposed_raw_tensors_are_not(ref):
    name = "dimenet@molecule"
    cfg = gnn_config_from_jax(json.loads(str(ref[name + "__cfg"])))
    params = _prefixed(ref, f"{name}__p__")
    sd = gnn_state_dict_from_jax(params, cfg)
    np.testing.assert_array_equal(sd["embed_node.weight"].numpy(),
                                  params["embed_node/w"].T)
    np.testing.assert_array_equal(sd["blocks.0.bilinear"].numpy(),
                                  params["blocks/0/bilinear"])
    name = "equiformer-v2@molecule"
    cfg = gnn_config_from_jax(json.loads(str(ref[name + "__cfg"])))
    params = _prefixed(ref, f"{name}__p__")
    sd = gnn_state_dict_from_jax(params, cfg)
    for raw in ("mix", "norm_scale"):
        np.testing.assert_array_equal(sd[f"layers.1.{raw}"].numpy(),
                                      params[f"layers/1/{raw}"])


def test_seeded_weights_are_reproducible():
    cfg = get_config("equiformer-v2", reduced=True)
    shape = gnn_shape("molecule")
    a, b = (build_defs(cfg, shape, device="cpu", seed=3) for _ in range(2))
    c = build_defs(cfg, shape, device="cpu", seed=4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(("weight", "mix")):
            assert not torch.equal(pa, pc), name


# ---------------------------- on the card -----------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_card_loss_and_gradients_match_the_cpu(cuda, name):
    """Each model's loss within 1e-4 relative and each gradient leaf
    within 1e-3 of its largest magnitude (a leaf of ``near_zero_leaves``:
    within 1e-5 of the model's largest gradient), the card against the
    CPU (the card sums with atomics, in no fixed order)."""
    arch, shape_name, extra = CASES[name]
    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, extra=cfg.extra + extra)
    shape = ShapeSpec(shape_name, "train", (("d_feat", 8),))
    cpu = build_defs(cfg, shape, device="cpu")
    card = build_defs(cfg, shape, device=cuda)
    card.load_state_dict(cpu.state_dict())
    raw = case_batch(arch, shape_name, 0)
    lc, _, gc = loss_and_grads(build_loss(cfg), cpu, to_device(raw, "cpu"))
    lg, _, gg = loss_and_grads(build_loss(cfg), card, to_device(raw, cuda))
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
    largest = max(float(g.abs().max()) for g in gc.values())
    _leaf_close({k: v.cpu() for k, v in gg.items()}, gc, 1e-3,
                f"{name} card gradient", near_zero_leaves(cpu, cfg),
                10 * ZERO_TOL / 1e-3 * largest)
