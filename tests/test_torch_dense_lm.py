"""The dense LMs qwen2-7b and qwen1.5-110b, and the full arch registry,
against the JAX package, on the CPU.

The JAX side runs once per module in a child process
(``test_torch_harness.run_reference``), its weights drawn from
``PRNGKey(0)`` and carried across with ``models.convert``.

  - the registry: ``ALL_ARCHS``, ``ASSIGNED_ARCHS``, ``list_archs``,
    every ``*_SHAPES`` cell and ``shapes_for`` of every arch, and every
    ``get_config(arch, reduced)``, field by field (JAX's attention names
    "xla" / "pallas" read as "torch" / "cuda");
  - full-size builds on the ``meta`` device: the parameter count of each
    dense LM (qwen1.5-110b also at the 6 layers the chip check serves)
    and every parameter's shape equal JAX's ``abstract_params`` through
    ``convert.param_shapes_from_jax``;
  - ``qwen2-7b-smoke`` and ``qwen1.5-110b-smoke`` in float32 at the
    tolerances ``test_torch_lm.py`` and ``test_torch_training.py`` hold
    qwen2-0.5b-smoke to: ``forward``, ``prefill`` (last logits and
    cache), three ``decode_step``s at 1e-4 (the Pallas kernel,
    interpreted, on the JAX side); ``serve_lm``'s ids identical; the loss
    within 1e-5 relative, every gradient leaf within 1e-4 of its largest
    magnitude, and 3 AdamW steps (clip and schedule in effect), each
    entry within 1e-4 of its leaf's largest magnitude plus AdamW's slack
    for gradient noise (``test_torch_training._steps``);
  - the plain attention at each model's head geometry (28 heads over 4
    kv heads, 64 over 8; head_dim 128, S = 64, causal) against JAX's
    ``attention_ref``: 1e-5 in float32, 2e-2 in bf16.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels.flash_attention import attention_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build_defs, build_loss  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    config_from_jax,
    gnn_config_from_jax,
    param_shapes_from_jax,
    recsys_config_from_jax,
    state_dict_from_jax,
)
from repro_torch.models.param import count_params  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    init_opt_state,
    make_train_step,
)
from repro_torch.training.loop import loss_and_grads, to_device  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

ARCHS = ("qwen2-7b", "qwen1.5-110b")
S = 128  # the Pallas kernel takes multiples of its 128-row tile
DECODE = 3
SERVE = dict(batch=2, prompt_len=128, decode_steps=8)
MODEL_TOL = 1e-4
# training, as test_torch_training.py: batch 2 x 32 tokens
TRAIN = dict(batch=2, seq=32)
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
STEPS = 3
TOL = 1e-4  # of a leaf's largest magnitude
LOSS_TOL = 1e-5  # relative
GRAD_NOISE = 1e-5  # float32 noise of a gradient entry, of its leaf's largest
# full-size builds: (name, arch, layers or None for the config's)
FULL = (("qwen2-0.5b", "qwen2-0.5b", None), ("qwen2-7b", "qwen2-7b", None),
        ("qwen1.5-110b", "qwen1.5-110b", None),
        ("qwen1.5-110b@6", "qwen1.5-110b", 6))
PARAMS = {"qwen2-0.5b": 494_032_768, "qwen2-7b": 7_615_616_512,
          "qwen1.5-110b": 111_209_914_368, "qwen1.5-110b@6": 10_645_311_488}
GEOMETRY = {"qwen2-7b": (28, 4), "qwen1.5-110b": (64, 8)}
ATTN = dict(b=2, s=64, d=128)
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}

REFERENCE = """
import dataclasses
import json

import jax
import jax.numpy as jnp
from repro import configs
from repro.configs import base
from repro.kernels.flash_attention.ref import attention_ref
from repro.launch.train import _data_fn
from repro.models import build_defs, build_loss
from repro.models import transformer as T
from repro.models.param import abstract_params, count_params, init_params
from repro.training.loop import make_train_step
from repro.training.optimizer import AdamWConfig, init_opt_state


def flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def cells(shapes):
    return [[s.name, s.mode, [list(d) for d in s.dims]] for s in shapes]


reg = {"all": list(configs.ALL_ARCHS), "assigned": list(configs.ASSIGNED_ARCHS),
       "list": list(configs.list_archs()), "configs": {}, "shapes_for": {},
       "shapes": {n: cells(getattr(base, n)) for n in
                  ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
                   "MATCHING_SHAPES")}}
for arch in configs.ALL_ARCHS:
    for red in (False, True):
        cfg = configs.get_config(arch, reduced=red)
        reg["configs"][f"{arch}@{red}"] = [cfg.family, dataclasses.asdict(cfg)]
    reg["shapes_for"][arch] = [s.name for s in base.shapes_for(cfg)]
OUT["registry"] = json.dumps(reg)

for name, arch, layers in json.loads(str(IN["full"])):
    cfg = configs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    defs = build_defs(cfg)
    OUT[name + "__count"] = np.array(count_params(defs), np.int64)
    paths = jax.tree_util.tree_flatten_with_path(abstract_params(defs))[0]
    OUT[name + "__shapes"] = json.dumps({
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
        list(leaf.shape) for path, leaf in paths})

for arch in json.loads(str(IN["archs"])):
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              attention_impl="pallas")
    params = init_params(build_defs(cfg), jax.random.PRNGKey(0))
    OUT.update({f"{arch}__p__{k}": v for k, v in flat(params).items()})
    OUT[arch + "__cfg"] = json.dumps(dataclasses.asdict(cfg))
    tokens = jnp.asarray(IN[arch + "__tokens"])
    logits, _, _ = T.forward(params, tokens, cfg)
    OUT[arch + "__logits"] = logits
    last, cache = T.prefill(params, tokens, cfg)
    OUT[arch + "__last"] = last
    OUT[arch + "__k"], OUT[arch + "__v"] = cache["blocks"]
    s, nd = tokens.shape[1], int(IN["decode"])
    k, v = cache["blocks"]
    pad = ((0, 0), (0, 0), (0, nd), (0, 0), (0, 0))
    cache = {"blocks": (jnp.pad(k, pad), jnp.pad(v, pad))}
    tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
    for i in range(nd):
        OUT[f"{arch}__decode{i}__tok"] = tok
        lg, cache = T.decode_step(params, cache, tok, s + i, cfg)
        OUT[f"{arch}__decode{i}__logits"] = lg
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    OUT[arch + "__decode__k"], OUT[arch + "__decode__v"] = cache["blocks"]

    # launch/serve.py's serve_lm, which prints its ids and returns nothing
    batch, plen, steps = (int(x) for x in IN["serve"])
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab, (batch, plen)), jnp.int32)
    smax = plen + steps
    logits, cache = jax.jit(lambda p, t: T.prefill(p, t, cfg))(params, tokens)

    def grow(kv):
        k, v = kv
        kb = jnp.zeros((k.shape[0], batch, smax, *k.shape[3:]), k.dtype)
        return (kb.at[:, :, :plen].set(k),
                jnp.zeros_like(kb).at[:, :, :plen].set(v))

    cache = {g: grow(kv) for g, kv in cache.items()}
    step = jax.jit(lambda p, c, t, i: T.decode_step(p, c, t, i, cfg))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(steps - 1):
        lg, cache = step(params, cache, tok, jnp.int32(plen + i))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    OUT[arch + "__serve_ids"] = jnp.concatenate(out, 1)

    # training: the loss, its gradients and 3 AdamW steps, attention "xla"
    cfg = configs.get_config(arch, reduced=True)
    OUT[arch + "__train_cfg"] = json.dumps(dataclasses.asdict(cfg))
    batch, seq = (int(x) for x in IN["train"])
    data = _data_fn(cfg, batch, seq)
    loss_fn = build_loss(cfg)
    (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(
        params, jax.tree.map(jnp.asarray, data(0)))
    OUT[arch + "__loss"] = loss
    OUT.update(flat(g, arch + "__g__"))
    opt = AdamWConfig(**json.loads(str(IN["opt"])))
    step = jax.jit(make_train_step(loss_fn, opt))
    p, o = params, init_opt_state(params)
    metrics = []
    for s in range(int(IN["steps"])):
        p, o, m = step(p, o, jax.tree.map(jnp.asarray, data(s)))
        metrics.append([m["loss"], m["grad_norm"], m["lr"]])
    OUT[arch + "__metrics"] = np.array(metrics, np.float32)
    OUT.update(flat(p, arch + "__p3__"))

for arch, (h, hkv) in json.loads(str(IN["geometry"])).items():
    for dt in ("float32", "bfloat16"):
        q, k, v = (jnp.asarray(IN[f"{arch}__attn_{x}"], getattr(jnp, dt))
                   for x in "qkv")
        OUT[f"{arch}__attn__{dt}"] = np.asarray(
            attention_ref(q, k, v, causal=True), np.float32)
"""


def _tokens(arch):
    rng = np.random.default_rng({"qwen2-7b": 1, "qwen1.5-110b": 2}[arch])
    return rng.integers(0, 512, (2, S)).astype(np.int32)


def _attn_inputs(arch):
    h, hkv = GEOMETRY[arch]
    b, s, d = ATTN["b"], ATTN["s"], ATTN["d"]
    rng = np.random.default_rng(len(arch))
    return {f"{arch}__attn_{x}": rng.normal(size=(b, n, s, d))
            .astype(np.float32) for x, n in (("q", h), ("k", hkv), ("v", hkv))}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = dict(archs=np.array(json.dumps(ARCHS)),
                  full=np.array(json.dumps(FULL)), decode=np.array(DECODE),
                  serve=np.array([SERVE["batch"], SERVE["prompt_len"],
                                  SERVE["decode_steps"]]),
                  train=np.array([TRAIN["batch"], TRAIN["seq"]]),
                  opt=np.array(json.dumps(OPT)), steps=np.array(STEPS),
                  geometry=np.array(json.dumps(GEOMETRY)))
    for arch in ARCHS:
        inputs[arch + "__tokens"] = _tokens(arch)
        inputs.update(_attn_inputs(arch))
    return run_reference(REFERENCE, inputs,
                         tmp_path_factory.mktemp("dense_lm"))


def _registry(ref):
    return json.loads(str(ref["registry"]))


def _prefixed(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _port_model(ref, arch, key="__cfg", attention_impl=None):
    cfg = config_from_jax(json.loads(str(ref[arch + key])))
    if attention_impl is not None:
        cfg = dataclasses.replace(cfg, attention_impl=attention_impl)
    model = build_defs(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        _prefixed(ref, f"{arch}__p__"), cfg))
    return model, cfg


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _cells(shapes):
    return [[s.name, s.mode, [list(d) for d in s.dims]] for s in shapes]


# ------------------------------ the registry --------------------------------


def test_arch_lists_equal_jax(ref):
    reg = _registry(ref)
    assert list(configs.ALL_ARCHS) == reg["all"]
    assert list(configs.ASSIGNED_ARCHS) == reg["assigned"]
    assert list(configs.list_archs()) == reg["list"]
    assert len(configs.ASSIGNED_ARCHS) == 10
    assert not hasattr(configs, "_NOT_YET")


@pytest.mark.parametrize("name", ["LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
                                  "MATCHING_SHAPES"])
def test_shape_cells_equal_jax(ref, name):
    assert _cells(getattr(base, name)) == _registry(ref)["shapes"][name]


def _from_jax(family, fields):
    if family == "lm":
        return config_from_jax(fields)
    if family == "recsys":
        return recsys_config_from_jax(fields)
    if family == "gnn":
        return gnn_config_from_jax(fields)
    return base.MatchingConfig(**fields)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_get_config_equals_jax(ref, arch, reduced):
    family, fields = _registry(ref)["configs"][f"{arch}@{reduced}"]
    cfg = configs.get_config(arch, reduced=reduced)
    assert cfg.family == family
    assert cfg == _from_jax(family, fields)
    assert [s.name for s in base.shapes_for(cfg)] == \
        _registry(ref)["shapes_for"][arch]


# --------------------------- full-size meta builds --------------------------


@pytest.mark.parametrize("name, arch, layers", FULL,
                         ids=[f[0] for f in FULL])
def test_full_size_meta_build_equals_jax(ref, name, arch, layers):
    cfg = configs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_defs(cfg, device="meta")
    assert {p.device.type for p in model.parameters()} == {"meta"}
    n = count_params(model)
    assert n == int(ref[name + "__count"]) == PARAMS[name]
    want = param_shapes_from_jax(json.loads(str(ref[name + "__shapes"])),
                                 cfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


# ----------------------------- serving, smoke size --------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(ref, arch):
    model, cfg = _port_model(ref, arch)
    assert cfg.attention_impl == "cuda" and not cfg.tie_embeddings
    assert model.lm_head is not None and cfg.qkv_bias
    logits, aux, cache = T.forward(model, torch.from_numpy(_tokens(arch)), cfg)
    assert logits.dtype == torch.float32 and cache is None
    assert float(aux) == 0.0
    _close(logits, ref[arch + "__logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(ref, arch):
    model, cfg = _port_model(ref, arch)
    last, cache = T.prefill(model, torch.from_numpy(_tokens(arch)), cfg)
    _close(last, ref[arch + "__last"])
    k, v = cache["blocks"]
    (shape, dtype), _ = T.cache_shapes(cfg, 2, S)["blocks"]
    assert k.shape == v.shape == shape and k.dtype == dtype
    _close(k, ref[arch + "__k"])
    _close(v, ref[arch + "__v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(ref, arch):
    model, cfg = _port_model(ref, arch)
    _, cache = T.prefill(model, torch.from_numpy(_tokens(arch)), cfg)
    k, v = cache["blocks"]
    pad = (0, 0, 0, 0, 0, DECODE)
    cache = {"blocks": (torch.nn.functional.pad(k, pad),
                        torch.nn.functional.pad(v, pad))}
    for i in range(DECODE):
        tok = torch.from_numpy(ref[f"{arch}__decode{i}__tok"]).long()
        lg, cache = T.decode_step(model, cache, tok, S + i, cfg)
        _close(lg, ref[f"{arch}__decode{i}__logits"])
    _close(cache["blocks"][0], ref[arch + "__decode__k"])
    _close(cache["blocks"][1], ref[arch + "__decode__v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_ids_match_jax(ref, arch, capsys):
    model, cfg = _port_model(ref, arch)
    out = serve.serve_lm(cfg, **SERVE, device="cpu", model=model)
    np.testing.assert_array_equal(out.ids.numpy(), ref[arch + "__serve_ids"])
    assert out.last_logits.shape == (SERVE["batch"], cfg.vocab)
    assert "prefill:" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_smoke_config(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--prompt-len", "8",
                "--decode-steps", "2"])
    out = capsys.readouterr().out
    assert "prefill: 2x8" in out and "decode:" in out


def test_launcher_refuses_the_matching_config():
    with pytest.raises(SystemExit, match="matching family"):
        serve.main(["--arch", "awpm-matching", "--device", "cpu"])


# ----------------------------- training, smoke size -------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_smoke_config(arch, capsys):
    hist = launcher.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "16"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert f"{arch}-smoke" in capsys.readouterr().out


def _batch(arch, step):
    cfg = configs.get_config(arch, reduced=True)
    return to_device(launcher._data_fn(cfg, TRAIN["batch"], TRAIN["seq"])(
        step), "cpu")


def _leaf_scale(w):
    return max(float(np.abs(w).max()), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(ref, arch):
    model, cfg = _port_model(ref, arch, "__train_cfg", attention_impl="cuda")
    loss, _, grads = loss_and_grads(build_loss(cfg), model, _batch(arch, 0))
    np.testing.assert_allclose(float(loss), float(ref[arch + "__loss"]),
                               rtol=LOSS_TOL)
    want = state_dict_from_jax(_prefixed(ref, f"{arch}__g__"), cfg)
    assert set(grads) == set(want)
    for k, w in want.items():
        w = w.numpy()
        err = float(np.abs(grads[k].numpy() - w).max()) / _leaf_scale(w)
        assert err <= TOL, f"{arch} gradient {k}: {err:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_jax(ref, arch):
    """Each parameter entry within TOL of its leaf's largest magnitude,
    plus AdamW's slack: lr times the gradient noise over the entry's
    gradient, capped at 2 lr a step (``test_torch_training._steps``)."""
    model, cfg = _port_model(ref, arch, "__train_cfg", attention_impl="cuda")
    opt_cfg = AdamWConfig(**OPT)
    step = make_train_step(build_loss(cfg), opt_cfg)
    opt = init_opt_state(model)
    metrics, slack = [], {}
    for s in range(STEPS):
        batch = _batch(arch, s)
        _, _, g = loss_and_grads(build_loss(cfg), model, batch)
        model, opt, m = step(model, opt, batch)
        lr = float(m["lr"])
        for k, gk in g.items():
            share = (GRAD_NOISE * float(gk.abs().max())
                     / gk.abs().clamp_min(1e-30)).clamp(max=2.0)
            slack[k] = slack.get(k, 0.0) + lr * share
        metrics.append([float(m["loss"]), float(m["grad_norm"]), lr])
    metrics = np.array(metrics)
    want = ref[arch + "__metrics"]
    np.testing.assert_allclose(metrics[:, 0], want[:, 0], rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics[:, 1:], want[:, 1:], rtol=TOL)
    assert (want[:, 1] > OPT["clip_norm"]).all()
    assert len(set(want[:, 2].tolist())) == STEPS
    p3 = state_dict_from_jax(_prefixed(ref, f"{arch}__p3__"), cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(p3)
    for k, w in p3.items():
        w = w.numpy()
        excess = np.abs(got[k].detach().numpy() - w) - slack[k].numpy()
        worst = float(excess.max()) / _leaf_scale(w)
        assert worst <= TOL, f"{arch} {k}: {worst:.3g} beyond its slack"


# ------------------------ attention at the head geometry --------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_attention_at_the_head_geometry_matches_jax(ref, arch, dtype):
    x = {k[-1]: torch.from_numpy(v).to(getattr(torch, dtype))
         for k, v in _attn_inputs(arch).items()}
    got = attention_plain(x["q"], x["k"], x["v"], causal=True)
    h, hkv = GEOMETRY[arch]
    assert got.shape == (ATTN["b"], h, ATTN["s"], ATTN["d"])
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref[f"{arch}__attn__{dtype}"], ATTN_TOL[dtype])


# ------------------------------- on the card --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: prefill attention runs the CUDA "
                    "kernel, which has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_at_the_head_geometry_on_the_card(cuda, arch):
    """K5 (bf16, D = 128) at each model's GQA group (7 and 8) against its
    plain version, within 2e-2, on a ragged S."""
    from repro_torch.kernels.flash_attention import flash_attention

    h, hkv = GEOMETRY[arch]
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, h, 300, 128), generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn((2, hkv, 300, 128), generator=gen, device=cuda)
            .bfloat16() for _ in range(2))
    got = flash_attention(q, k, v, causal=True)
    want = attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_on_the_card_equals_the_cpu(cuda, arch):
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              attention_impl="cuda")
    m_cpu = build_defs(cfg, device="cpu")
    import copy

    r_gpu = serve.serve_lm(cfg, 2, 128, 4, model=copy.deepcopy(m_cpu).to(cuda))
    r_cpu = serve.serve_lm(cfg, 2, 128, 4, device="cpu", model=m_cpu)
    assert torch.equal(r_gpu.ids.cpu(), r_cpu.ids)
    _close(r_gpu.last_logits.cpu(), r_cpu.last_logits.numpy())
