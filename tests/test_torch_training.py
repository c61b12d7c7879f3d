"""The port's training stack against the JAX package, on the CPU, at smoke
size: ``softmax_xent``, the losses (qwen2-0.5b plain and sequence-chunked;
bert4rec; qwen2-moe-a2.7b under the "topk" and
"awpm" routers), every gradient leaf, and the parameters after 3 AdamW
steps with clipping and the schedule in effect; the token streams; and the
train step, checkpoint and loop cases of the JAX package's
``tests/test_training_runtime.py``, with the launcher at smoke size.

The JAX side runs once per module in a child process
(``test_torch_harness.run_reference``), with its weights drawn from
``PRNGKey(0)`` and carried across with ``models.convert``. The JAX models
run attention through ``attention_ref`` ("xla"); the port's LMs take
``attention_impl="cuda"``, the flash-attention kernel's autograd path,
whose forward is the plain version on a CPU tensor. Tolerances: the loss
within 1e-5 relative, each gradient and parameter leaf within 1e-4 of
that leaf's largest magnitude, in float32 (float32 sums in other orders).
bert4rec's key biases have a gradient that is zero in exact arithmetic
(``ZERO_LEAVES``): there both sides must hold nothing above rounding
noise. After the AdamW steps each
parameter entry is held to 1e-4 of its leaf's largest magnitude plus a
slack for the gradient noise that AdamW's per-entry normalisation carries
into the step (``_steps``): lr times the noise over the entry's gradient,
so an entry with a small gradient, whose step is rounding noise over
rounding noise in both frameworks, may differ by up to the whole step.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build_defs, build_loss  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    bert4rec_state_dict_from_jax,
    config_from_jax,
    recsys_config_from_jax,
    state_dict_from_jax,
)
from repro_torch.models.layers import softmax_xent  # noqa: E402
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    make_train_step,
    schedule,
    train,
)
from repro_torch.training.loop import loss_and_grads, to_device  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

# name -> (arch, get_config kwargs, config overrides, batch, seq)
CASES = {
    "lm": ("qwen2-0.5b", {}, {}, 2, 32),
    "lm_chunked": ("qwen2-0.5b", {}, {"loss_chunks": 4}, 2, 32),
    "rec": ("bert4rec", {}, {}, 3, 16),
    "moe_topk": ("qwen2-moe-a2.7b", {"router": "topk"}, {}, 2, 16),
    "moe_awpm": ("qwen2-moe-a2.7b", {"router": "awpm"}, {}, 2, 16),
}
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
STEPS = 3
TOL = 1e-4  # of a leaf's largest magnitude
LOSS_TOL = 1e-5  # relative
# leaves whose gradient is zero in exact arithmetic: bert4rec's attention
# has no rotary embedding, so a key bias shifts each query's scores by one
# constant q.b_k, which the softmax cancels. Both sides hold rounding noise
# there, which must stay below ZERO_TOL of the model's largest gradient,
# and AdamW turns that noise into steps of about lr either way, so after
# the steps those parameters are held to STEPS * lr, not to JAX's values.
ZERO_LEAVES = {"rec": ("blocks.0.k.bias", "blocks.1.k.bias")}
ZERO_TOL = 1e-6
# float32 rounding noise of a gradient entry, as a share of its leaf's
# largest magnitude: the gradients above agree with JAX to 2.5e-6 of it
GRAD_NOISE = 1e-5
PIPE = dict(vocab=512, global_batch=4, seq_len=16, seed=3)

REFERENCE = """
import dataclasses
import json

import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.data.tokens import TokenPipeline
from repro.launch.train import _data_fn
from repro.models import build_defs, build_loss
from repro.models.layers import softmax_xent
from repro.models.param import init_params
from repro.training.loop import make_train_step
from repro.training.optimizer import (AdamWConfig, adamw_update,
                                      global_norm, init_opt_state, schedule)


def flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


OUT["xent"] = softmax_xent(IN["logits"], IN["labels"], IN["mask"])
OUT["xent_nomask"] = softmax_xent(IN["logits"], IN["labels"])
opt = AdamWConfig(**json.loads(str(IN["opt"])))
OUT["sched"] = np.array([schedule(opt, jnp.float32(s)) for s in range(12)])
pipe = TokenPipeline(**json.loads(str(IN["pipe"])))
for s in range(3):
    for k, v in pipe.batch(s).items():
        OUT[f"pipe{s}__{k}"] = v

# one AdamW update of a toy tree, clip in effect
tree = {"a": IN["toy_a"], "b": IN["toy_b"]}
grads = {"a": IN["toy_ga"], "b": IN["toy_gb"]}
p1, st, m = adamw_update(opt, tree, grads, init_opt_state(tree))
OUT["toy_a1"], OUT["toy_b1"] = p1["a"], p1["b"]
OUT["toy_gn"], OUT["toy_lr"] = m["grad_norm"], m["lr"]
OUT["toy_m_a"], OUT["toy_v_b"] = st.m["a"], st.v["b"]

for name, (arch, kw, over, batch, seq) in json.loads(str(IN["cases"])).items():
    cfg = dataclasses.replace(get_config(arch, reduced=True, **kw), **over)
    OUT[name + "__cfg"] = json.dumps(dataclasses.asdict(cfg))
    params = init_params(build_defs(cfg), jax.random.PRNGKey(0))
    OUT.update(flat(params, name + "__p__"))
    data = _data_fn(cfg, batch, seq)
    loss_fn = build_loss(cfg)
    b0 = jax.tree.map(jnp.asarray, data(0))
    for k, v in data(0).items():
        OUT[f"{name}__batch__{k}"] = v
    (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(params, b0)
    OUT[name + "__loss"] = loss
    OUT[name + "__xent"] = aux["xent"]
    OUT[name + "__aux"] = aux.get("aux", jnp.float32(0.0))
    OUT.update(flat(g, name + "__g__"))
    step = jax.jit(make_train_step(loss_fn, opt))
    p, o = params, init_opt_state(params)
    losses = []
    for s in range(int(IN["steps"])):
        p, o, m = step(p, o, jax.tree.map(jnp.asarray, data(s)))
        losses.append([m["loss"], m["grad_norm"], m["lr"]])
    OUT[name + "__metrics"] = np.array(losses, np.float32)
    OUT.update(flat(p, name + "__p3__"))
"""


def _toy():
    rng = np.random.default_rng(11)
    return {k: rng.normal(size=shape).astype(np.float32)
            for k, shape in (("toy_a", (4, 3)), ("toy_b", (5,)),
                             ("toy_ga", (4, 3)), ("toy_gb", (5,)))}


def _xent_inputs():
    rng = np.random.default_rng(5)
    return {"logits": rng.normal(size=(3, 7, 11)).astype(np.float32) * 3,
            "labels": rng.integers(0, 11, (3, 7)).astype(np.int32),
            "mask": (rng.random((3, 7)) < 0.6).astype(np.float32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = dict(cases=np.array(json.dumps(CASES)),
                  opt=np.array(json.dumps(OPT)),
                  pipe=np.array(json.dumps(PIPE)), steps=np.array(STEPS),
                  **_xent_inputs(), **_toy())
    return run_reference(REFERENCE, inputs,
                         tmp_path_factory.mktemp("training"))


def _prefixed(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _port_model(ref, name):
    """The port's model of a case with JAX's weights, and its config: the
    LMs on the flash-attention kernel's path."""
    fields = json.loads(str(ref[name + "__cfg"]))
    if "vocab" in fields:
        cfg = dataclasses.replace(config_from_jax(fields),
                                  attention_impl="cuda")
        convert = state_dict_from_jax
    else:
        cfg = recsys_config_from_jax(fields)
        convert = bert4rec_state_dict_from_jax
    model = build_defs(cfg, device="cpu")
    model.load_state_dict(convert(_prefixed(ref, f"{name}__p__"), cfg))
    return model, cfg, convert


def _leaf_close(got: dict, want: dict, tol: float, what: str,
                zero=(), zero_bound=None):
    """Every leaf within ``tol`` of its largest magnitude; the ``zero``
    leaves (zero in exact arithmetic) at most ``zero_bound`` in magnitude
    on both sides instead."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        w = w.astype(np.float32)
        if k in zero:
            worst = max(float(np.abs(g).max()), float(np.abs(w).max()))
            assert worst <= zero_bound, f"{what} {k}: {worst:.3g}"
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, f"{what} {k}: {err:.3g} of its largest magnitude"


def _batch(name, step):
    arch, kw, over, batch, seq = CASES[name]
    cfg = dataclasses.replace(get_config(arch, reduced=True, **kw), **over)
    return launcher._data_fn(cfg, batch, seq)(step)


def test_softmax_xent_matches_jax(ref):
    x = {k: torch.from_numpy(v) for k, v in _xent_inputs().items()}
    got = softmax_xent(x["logits"], x["labels"], x["mask"])
    np.testing.assert_allclose(float(got), float(ref["xent"]), rtol=1e-6)
    got = softmax_xent(x["logits"], x["labels"])
    np.testing.assert_allclose(float(got), float(ref["xent_nomask"]),
                               rtol=1e-6)
    # an all-zero mask divides by max(count, 1), as in JAX
    assert float(softmax_xent(x["logits"], x["labels"],
                              torch.zeros(3, 7))) == 0.0


def test_token_streams_equal_jax(ref):
    pipe = TokenPipeline(**PIPE)
    for s in range(3):
        for k, v in pipe.batch(s).items():
            want = ref[f"pipe{s}__{k}"]
            assert v.dtype == want.dtype
            np.testing.assert_array_equal(v, want)


@pytest.mark.parametrize("name", CASES)
def test_launcher_batches_equal_jax(ref, name):
    for k, v in _batch(name, 0).items():
        want = ref[f"{name}__batch__{k}"]
        assert v.dtype == want.dtype, k
        np.testing.assert_array_equal(v, want)


def test_schedule_and_adamw_update_match_jax(ref):
    cfg = AdamWConfig(**OPT)
    got = [float(schedule(cfg, torch.tensor(s, dtype=torch.float32)))
           for s in range(12)]
    np.testing.assert_allclose(got, ref["sched"], rtol=1e-6)
    toy = {k: torch.from_numpy(v.copy()) for k, v in _toy().items()}
    params = {"a": toy["toy_a"], "b": toy["toy_b"]}
    grads = {"a": toy["toy_ga"], "b": toy["toy_gb"]}
    params, st, m = adamw_update(cfg, params, grads, init_opt_state(params))
    np.testing.assert_allclose(float(m["grad_norm"]), float(ref["toy_gn"]),
                               rtol=1e-6)
    assert float(m["grad_norm"]) > cfg.clip_norm  # the clip is in effect
    np.testing.assert_allclose(float(m["lr"]), float(ref["toy_lr"]),
                               rtol=1e-6)
    for k, want in (("a", "toy_a1"), ("b", "toy_b1")):
        np.testing.assert_allclose(params[k].numpy(), ref[want], rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(st.m["a"].numpy(), ref["toy_m_a"], rtol=1e-6)
    np.testing.assert_allclose(st.v["b"].numpy(), ref["toy_v_b"], rtol=1e-6)
    assert int(st.step) == 1 and st.step.dtype == torch.int32


@pytest.mark.parametrize("name", CASES)
def test_loss_and_gradients_match_jax(ref, name):
    model, cfg, convert = _port_model(ref, name)
    loss_fn = build_loss(cfg)
    batch = to_device(_batch(name, 0), "cpu")
    loss, aux, grads = loss_and_grads(loss_fn, model, batch)
    np.testing.assert_allclose(float(loss), float(ref[name + "__loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(aux["xent"].detach()),
                               float(ref[name + "__xent"]), rtol=LOSS_TOL)
    if "aux" in aux:
        np.testing.assert_allclose(float(aux["aux"].detach()),
                                   float(ref[name + "__aux"]),
                                   rtol=LOSS_TOL, atol=1e-9)
    want = {k: v.numpy() for k, v in
            convert(_prefixed(ref, f"{name}__g__"), cfg).items()}
    largest = max(float(np.abs(w).max()) for w in want.values())
    _leaf_close(grads, want, TOL, f"{name} gradient",
                zero=ZERO_LEAVES.get(name, ()),
                zero_bound=ZERO_TOL * largest)


@pytest.mark.parametrize("name", CASES)
def _steps(model, cfg, name, n, opt_cfg, grad_accum=1):
    """``n`` train steps of ``model`` on the case's stream: (metrics per
    step, {name: each entry's slack}). AdamW normalises each gradient entry
    by its own root mean square, so a relative error of the gradient
    becomes the same relative error of a step of about lr: an entry whose
    gradient is a small share of its leaf's largest carries float32
    rounding noise (GRAD_NOISE of that largest, in JAX as here) into its
    step in that ratio, capped at the two steps' difference of 2 lr."""
    step = make_train_step(build_loss(cfg), opt_cfg, grad_accum)
    opt = init_opt_state(model)
    metrics, slack = [], {}
    for s in range(n):
        batch = to_device(_batch(name, s), "cpu")
        _, _, g = loss_and_grads(build_loss(cfg), model, batch)
        model, opt, m = step(model, opt, batch)
        lr = float(m["lr"])
        largest = max(float(gk.abs().max()) for gk in g.values())
        for k, gk in g.items():
            # a leaf that is zero in exact arithmetic holds noise of the
            # terms it sums, which the model's largest gradient bounds
            top = largest if k in ZERO_LEAVES.get(name, ()) \
                else float(gk.abs().max())
            noise = GRAD_NOISE * top
            share = (noise / gk.abs().clamp_min(1e-30)).clamp(max=2.0)
            slack[k] = slack.get(k, 0.0) + lr * share
        metrics.append([float(m["loss"]), float(m["grad_norm"]), lr])
    return np.array(metrics), slack


def _params_close(model, want: dict, slack: dict, what):
    """Every parameter entry within TOL of its leaf's largest magnitude,
    plus its AdamW slack (``_steps``)."""
    got = dict(model.named_parameters())
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k].detach().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        excess = np.abs(g - w) - slack[k].numpy()
        worst = float(excess.max()) / scale
        assert worst <= TOL, f"{what} {k}: {worst:.3g} of its largest " \
                             f"magnitude beyond its slack"


@pytest.mark.parametrize("name", CASES)
def test_three_adamw_steps_match_jax(ref, name):
    model, cfg, convert = _port_model(ref, name)
    metrics, slack = _steps(model, cfg, name, STEPS, AdamWConfig(**OPT))
    want = ref[name + "__metrics"]
    np.testing.assert_allclose(metrics[:, 0], want[:, 0], rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics[:, 1:], want[:, 1:], rtol=TOL)
    # the clip and the schedule are in effect
    assert (want[:, 1] > OPT["clip_norm"]).all()
    assert len(set(want[:, 2].tolist())) == STEPS
    p3 = convert(_prefixed(ref, f"{name}__p3__"), cfg)
    _params_close(model, {k: v.numpy() for k, v in p3.items()}, slack,
                  f"{name} parameters after {STEPS} steps")


def test_kernel_path_equals_plain_path_on_the_cpu(ref):
    # on CPU tensors the kernel path's forward is the plain version, so
    # "cuda" and "torch" give the same loss and gradients, bit for bit
    model, cfg, _ = _port_model(ref, "lm")
    batch = to_device(_batch("lm", 0), "cpu")
    reset_launch_counts()
    l1, _, g1 = loss_and_grads(build_loss(cfg), model, batch)
    assert launch_counts()["flash_attention"] == 0
    plain = dataclasses.replace(cfg, attention_impl="torch")
    l2, _, g2 = loss_and_grads(build_loss(plain), model, batch)
    assert float(l1) == float(l2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def test_remat_changes_no_number(ref):
    model, cfg, _ = _port_model(ref, "moe_topk")
    batch = to_device(_batch("moe_topk", 0), "cpu")
    assert cfg.remat
    l1, _, g1 = loss_and_grads(build_loss(cfg), model, batch)
    l2, _, g2 = loss_and_grads(build_loss(dataclasses.replace(cfg, remat=False)),
                       model, batch)
    assert float(l1) == float(l2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def test_gnn_family_has_no_loss_yet():
    """``build_loss`` gives the GNN family its loss: graphsage's on a
    small graph of the launcher's stream, finite, with the logits as
    aux. (The name dates from before the GNN port; the test now checks
    the loss that was missing.)"""
    cfg = get_config("graphsage-reddit", reduced=True)
    batch = launcher._data_fn(cfg, 1, 1)(0).to("cpu")
    shape = launcher.gnn_train_shape()
    model = build_defs(cfg, shape, device="cpu")
    loss, logits = build_loss(cfg)(model, batch)
    assert loss.requires_grad and torch.isfinite(loss)
    assert logits.shape == (batch.node_feat.shape[0], 7)


def test_serving_entries_keep_no_graph(ref):
    from repro_torch.models import transformer as T

    model, cfg, _ = _port_model(ref, "lm")
    logits, _, _ = T.forward(model, torch.zeros(1, 8, dtype=torch.int32),
                             cfg)
    assert not logits.requires_grad


# ------------------- the JAX package's training-runtime cases ---------------


def _quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {}


def _toy_params(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 2, generator=g), "b": torch.zeros(2)}


def _toy_batch(step):
    rng = np.random.default_rng(step)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    w_true = np.array([[1.0, -1], [2, 0.5], [-0.5, 1], [0, 2]], np.float32)
    return {"x": x, "y": x @ w_true}


def test_train_step_reduces_loss():
    params = _toy_params(0)
    cfg = AdamWConfig(lr=5e-2, warmup_steps=5, total_steps=200,
                      weight_decay=0.0)
    step = make_train_step(_quad_loss, cfg)
    opt = init_opt_state(params)
    l0 = float(_quad_loss(params, to_device(_toy_batch(0), "cpu"))[0])
    for i in range(100):
        params, opt, m = step(params, opt, to_device(_toy_batch(i), "cpu"))
    assert float(m["loss"]) < 0.1 * l0


def test_grad_accum_matches_full_batch():
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.0, clip_norm=1e9)
    batch = to_device(_toy_batch(3), "cpu")
    p1, p4 = _toy_params(1), _toy_params(1)
    p1, _, m1 = make_train_step(_quad_loss, cfg)(p1, init_opt_state(p1),
                                                 batch)
    p4, _, m4 = make_train_step(_quad_loss, cfg, grad_accum=4)(
        p4, init_opt_state(p4), batch)
    for k in p1:
        np.testing.assert_allclose(p1[k].detach().numpy(),
                                   p4[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)


def test_grad_accum_2_matches_the_full_batch_on_the_lm(ref):
    # the mean cross-entropy over equal microbatches: accumulation of 2
    # gives the full batch's step
    cfg_opt = AdamWConfig(**OPT)
    m1, cfg, _ = _port_model(ref, "lm")
    m2, _, _ = _port_model(ref, "lm")
    a, slack = _steps(m1, cfg, "lm", 1, cfg_opt)
    b, _ = _steps(m2, cfg, "lm", 1, cfg_opt, grad_accum=2)
    np.testing.assert_allclose(a[:, :2], b[:, :2], rtol=1e-5)
    _params_close(m2, {k: p.detach().numpy()
                       for k, p in m1.named_parameters()}, slack,
                  "grad-accum 2 against the full batch")


def test_global_norm_is_float32():
    x = [torch.ones(3, dtype=torch.bfloat16), torch.full((4,), 2.0)]
    gn = global_norm(x)
    assert gn.dtype == torch.float32 and float(gn) == pytest.approx(
        (3 + 16) ** 0.5)


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    params = _toy_params(2)
    opt = init_opt_state(params)
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(10, params, opt)
    mgr.save(20, params, opt)
    mgr.save(30, params, opt)
    assert mgr.list_steps() == [20, 30]  # keep=2 removed step 10
    p2, o2, step = mgr.restore_latest(like={"params": params, "opt": opt})
    assert step == 30
    for k in params:
        assert torch.equal(params[k], p2[k])
    assert o2.step.dtype == torch.int32 and set(o2.m) == set(params)
    # one .npy per leaf plus the manifest
    files = sorted(p.name for p in (tmp_path / "step_000000030").iterdir())
    assert files[-1] == "manifest.json" and len(files) == 1 + 2 + 1 + 2 + 2
    # a stale .tmp dir must not be listed as a checkpoint
    (tmp_path / "step_000000040.tmp").mkdir()
    assert mgr.list_steps() == [20, 30]
    # a prototype of another structure is refused
    with pytest.raises(ValueError, match="do not match"):
        mgr.restore(30, like={"params": {"w": params["w"]}, "opt": opt})
    with pytest.raises(ValueError, match="like"):
        mgr.restore(30)


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, _toy_params(3))
    mgr.wait()
    assert mgr.list_steps() == [1]


def test_train_loop_restores_from_checkpoint(tmp_path, capsys):
    cfg = AdamWConfig(lr=1e-2)
    mgr = CheckpointManager(tmp_path)
    p1, o1, hist = train(_toy_params(4), _quad_loss, _toy_batch, cfg,
                         n_steps=6, checkpoint_mgr=mgr, checkpoint_every=2,
                         log_every=100)
    assert mgr.list_steps() == [2, 4]
    # a second run resumes from the saved step, with the saved state
    p2, o2, hist2 = train(_toy_params(4), _quad_loss, _toy_batch, cfg,
                          n_steps=6, checkpoint_mgr=mgr, checkpoint_every=2,
                          log_every=100)
    assert int(o2.step) >= int(o1.step) - 4
    assert [h["step"] for h in hist2] == [5]


def test_restore_resumes_the_same_stream(tmp_path, ref):
    # an uninterrupted run of 4 steps and a run stopped after step 2 and
    # resumed from its checkpoint end on the same parameters
    _, cfg, _ = _port_model(ref, "lm")
    data = launcher._data_fn(cfg, 2, 32)
    opt = AdamWConfig(**OPT)
    whole, _, _ = _port_model(ref, "lm")
    train(whole, build_loss(cfg), data, opt, n_steps=4, log_every=100)
    part, _, _ = _port_model(ref, "lm")
    mgr = CheckpointManager(tmp_path)
    train(part, build_loss(cfg), data, opt, n_steps=3, log_every=100,
          checkpoint_mgr=mgr, checkpoint_every=2)
    assert mgr.list_steps() == [2]
    resumed, _, _ = _port_model(ref, "lm")  # fresh weights: restore wins
    _, o, hist = train(resumed, build_loss(cfg), data, opt, n_steps=4,
                       log_every=1, checkpoint_mgr=mgr, checkpoint_every=2)
    assert [h["step"] for h in hist] == [3] and int(o.step) == 4
    for (k, a), b in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), k


def test_straggler_monitor_flags_slow_rank():
    mon = StragglerMonitor(warmup=3)
    for step in range(10):
        for rank in range(8):
            mon.record(step, 1.0 + (5.0 if rank == 3 else 0.0), rank)
    assert mon.slow_ranks() == [3]


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-0.5b", "--steps", "4", "--seq", "16"],
    ["--arch", "bert4rec", "--steps", "3", "--batch", "2"],
    ["--arch", "qwen2-moe-a2.7b", "--router", "awpm", "--steps", "2",
     "--seq", "16", "--grad-accum", "2"],
])
def test_cli_trains_at_smoke_size(tmp_path, argv, capsys):
    hist = launcher.main(argv + ["--device", "cpu", "--ckpt-dir",
                                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "M params on cpu" in out and "final loss" in out
    assert np.isfinite(hist[-1]["loss"])
    assert CheckpointManager(tmp_path).list_steps()


def test_cli_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "qwen2-0.5b", "--steps", "1"])


# ------------------------------- on the card -------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernel is CUDA "
                    "C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["lm", "moe_topk"])
def test_training_step_on_the_card_matches_the_cpu(cuda, name):
    # float32 smoke model: K5's float32 kernel forward (within 2e-5 of the
    # plain version) under autograd, against the same step on the CPU
    arch, kw, over, _, _ = CASES[name]
    cfg = dataclasses.replace(get_config(arch, reduced=True, **kw), **over,
                              attention_impl="cuda")
    model = build_defs(cfg, device="cpu")
    card = build_defs(cfg, device=cuda)
    card.load_state_dict(model.state_dict())
    batch = _batch(name, 0)
    reset_launch_counts()
    lc, _, gc = loss_and_grads(build_loss(cfg), card, to_device(batch, cuda))
    torch.cuda.synchronize()
    # one launch per layer in the forward, one more per layer when remat
    # recomputes the block in backward
    assert launch_counts()["flash_attention"] == 2 * cfg.n_layers
    lh, _, gh = loss_and_grads(build_loss(cfg), model, to_device(batch, "cpu"))
    np.testing.assert_allclose(float(lc), float(lh), rtol=1e-4)
    _leaf_close({k: g.cpu() for k, g in gc.items()},
                {k: g.numpy() for k, g in gh.items()}, 1e-3,
                f"{name} gradient on the card")
