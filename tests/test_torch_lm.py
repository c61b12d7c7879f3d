"""The port's LM serving path against the JAX package, on the CPU.

The JAX side runs once per module in a child process
(``test_torch_harness.run_reference``) with ``attention_impl="pallas"``
(the Pallas kernel, interpreted); its weights (``init_params`` from
``PRNGKey(0)``, as the JAX launcher draws them) are carried across to the
port with ``models.convert``, whose config mapping turns "pallas" into
"cuda": on CPU tensors the port's kernel wrapper takes its plain version.

  - ``rmsnorm``, ``rope`` and the SwiGLU ``mlp`` against JAX, in float32
    (1e-5: summation order) and bf16 (2e-2, about two bf16 ulps: the two
    frameworks round bf16 intermediates at other places);
  - on ``qwen2-0.5b-smoke`` in float32: ``forward``'s logits and
    ``prefill``'s last logits and cache, three ``decode_step``s (logits
    and cache), at rtol/atol 1e-4 (float32 products summed in another
    order in two frameworks, over two layers); ``serve_lm``'s generated
    ids, which must be identical;
  - the same forward and prefill at qwen2-0.5b's own head geometry (14
    heads, 2 kv heads, head_dim 64, d_model 896) with 2 layers, d_ff 128
    and a 512-token vocabulary;
  - the config registry, the converter's refusals, and the launcher's
    refusal to fall back to the CPU.

The ``gpu`` tests run the path on the card and skip here.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LMConfig, MoECfg  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_defs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    config_from_jax,
    state_dict_from_jax,
)
from repro_torch.models.layers import MLP, rmsnorm, rope  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

S = 128  # the Pallas kernel takes multiples of its 128-row tile
DECODE = 3
SERVE = dict(batch=2, prompt_len=128, decode_steps=8)
MODELS = ("smoke", "geom")
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_TOL = 1e-4

REFERENCE = """
import dataclasses
import json

import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.configs.qwen2_0_5b import config as qwen2_0_5b
from repro.models import build_defs
from repro.models import transformer as T
from repro.models.layers import mlp, rmsnorm, rope
from repro.models.param import init_params


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


for dt in ("float32", "bfloat16"):
    cast = lambda a: jnp.asarray(a, getattr(jnp, dt))
    OUT["rmsnorm__" + dt] = np.asarray(
        rmsnorm({"scale": IN["scale"]}, cast(IN["x"])), np.float32)
    OUT["rope__" + dt] = np.asarray(
        rope(cast(IN["xr"]), IN["pos"], 1e6), np.float32)
    p = {n: {"w": IN["mlp_" + n]} for n in ("gate", "up", "down")}
    OUT["mlp__" + dt] = np.asarray(mlp(p, cast(IN["x"])), np.float32)

smoke = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                            attention_impl="pallas")
geom = dataclasses.replace(qwen2_0_5b(), n_layers=2, d_ff=128, vocab=512,
                           dtype="float32", attention_impl="pallas")
OUT["smoke_xla__cfg"] = json.dumps(dataclasses.asdict(
    get_config("qwen2-0.5b", reduced=True)))
for name, cfg in (("smoke", smoke), ("geom", geom)):
    params = init_params(build_defs(cfg), jax.random.PRNGKey(0))
    OUT.update({f"{name}__p__{k}": v for k, v in flat(params).items()})
    OUT[name + "__cfg"] = json.dumps(dataclasses.asdict(cfg))
    tokens = jnp.asarray(IN[name + "__tokens"])
    logits, _, _ = T.forward(params, tokens, cfg)
    OUT[name + "__logits"] = logits
    last, cache = T.prefill(params, tokens, cfg)
    OUT[name + "__last"] = last
    OUT[name + "__k"], OUT[name + "__v"] = cache["blocks"]
    if name != "smoke":
        continue
    s, nd = tokens.shape[1], int(IN["decode"])
    k, v = cache["blocks"]
    pad = ((0, 0), (0, 0), (0, nd), (0, 0), (0, 0))
    cache = {"blocks": (jnp.pad(k, pad), jnp.pad(v, pad))}
    tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
    for i in range(nd):
        OUT[f"decode{i}__tok"] = tok
        lg, cache = T.decode_step(params, cache, tok, s + i, cfg)
        OUT[f"decode{i}__logits"] = lg
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    OUT["decode__k"], OUT["decode__v"] = cache["blocks"]

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
    OUT["serve__ids"] = jnp.concatenate(out, 1)
"""


def _layer_inputs():
    rng = np.random.default_rng(7)
    d, hidden = 64, 128

    def w(fan_in, shape):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return {
        "x": rng.normal(size=(2, 8, d)).astype(np.float32),
        "scale": (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32),
        "xr": rng.normal(size=(2, 8, 4, 16)).astype(np.float32),
        "pos": np.tile(np.arange(8, dtype=np.int32) * 37, (2, 1)),
        "mlp_gate": w(d, (d, hidden)), "mlp_up": w(d, (d, hidden)),
        "mlp_down": w(hidden, (hidden, d)),
    }


LAYERS = _layer_inputs()


def _tokens(name):
    rng = np.random.default_rng({"smoke": 1, "geom": 2}[name])
    return rng.integers(0, 512, (2, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = dict(LAYERS, decode=np.array(DECODE),
                  serve=np.array([SERVE["batch"], SERVE["prompt_len"],
                                  SERVE["decode_steps"]]))
    for name in MODELS:
        inputs[name + "__tokens"] = _tokens(name)
    return run_reference(REFERENCE, inputs, tmp_path_factory.mktemp("lm"))


def _port_model(ref, name):
    cfg = config_from_jax(json.loads(str(ref[name + "__cfg"])))
    prefix = f"{name}__p__"
    params = {k[len(prefix):]: v for k, v in ref.items()
              if k.startswith(prefix)}
    model = build_defs(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return model, cfg


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# ------------------------------- layers -------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(ref, dtype):
    x = torch.from_numpy(LAYERS["x"]).to(getattr(torch, dtype))
    got = rmsnorm(torch.from_numpy(LAYERS["scale"]), x)
    assert got.dtype == x.dtype
    _close(got, ref["rmsnorm__" + dtype], LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(ref, dtype):
    x = torch.from_numpy(LAYERS["xr"]).to(getattr(torch, dtype))
    got = rope(x, torch.from_numpy(LAYERS["pos"]), 1e6)
    assert got.dtype == x.dtype
    _close(got, ref["rope__" + dtype], LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_jax(ref, dtype):
    m = MLP(64, 128)
    with torch.no_grad():
        for n in ("gate", "up", "down"):
            getattr(m, n).weight.copy_(torch.from_numpy(LAYERS["mlp_" + n].T))
        x = torch.from_numpy(LAYERS["x"]).to(getattr(torch, dtype))
        got = m(x)
    assert got.dtype == x.dtype
    _close(got, ref["mlp__" + dtype], LAYER_TOL[dtype])


# ------------------------------- the model ----------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(ref, name):
    model, cfg = _port_model(ref, name)
    assert cfg.attention_impl == "cuda"
    tokens = torch.from_numpy(_tokens(name))
    logits, aux, cache = T.forward(model, tokens, cfg)
    assert logits.dtype == torch.float32 and cache is None
    assert float(aux) == 0.0
    _close(logits, ref[name + "__logits"])


@pytest.mark.parametrize("name", MODELS)
def test_prefill_matches_jax(ref, name):
    model, cfg = _port_model(ref, name)
    last, cache = T.prefill(model, torch.from_numpy(_tokens(name)), cfg)
    _close(last, ref[name + "__last"])
    k, v = cache["blocks"]
    (shape, dtype), _ = T.cache_shapes(cfg, 2, S)["blocks"]
    assert k.shape == v.shape == shape and k.dtype == dtype
    _close(k, ref[name + "__k"])
    _close(v, ref[name + "__v"])


def test_decode_steps_match_jax(ref):
    model, cfg = _port_model(ref, "smoke")
    _, cache = T.prefill(model, torch.from_numpy(_tokens("smoke")), cfg)
    k, v = cache["blocks"]
    pad = (0, 0, 0, 0, 0, DECODE)
    cache = {"blocks": (torch.nn.functional.pad(k, pad),
                        torch.nn.functional.pad(v, pad))}
    for i in range(DECODE):
        tok = torch.from_numpy(ref[f"decode{i}__tok"]).long()
        lg, cache = T.decode_step(model, cache, tok, S + i, cfg)
        _close(lg, ref[f"decode{i}__logits"])
    _close(cache["blocks"][0], ref["decode__k"])
    _close(cache["blocks"][1], ref["decode__v"])


def test_serve_lm_ids_match_jax(ref, capsys):
    model, cfg = _port_model(ref, "smoke")
    out = serve.serve_lm(cfg, **SERVE, device="cpu", model=model)
    np.testing.assert_array_equal(out.ids.numpy(), ref["serve__ids"])
    assert out.last_logits.shape == (SERVE["batch"], cfg.vocab)
    assert "prefill:" in capsys.readouterr().out


def test_registry_copies_the_jax_configs(ref):
    want = config_from_jax(json.loads(str(ref["smoke_xla__cfg"])))
    assert get_config("qwen2-0.5b", reduced=True) == want
    assert want.attention_impl == "torch"
    full = get_config("qwen2-0.5b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab) == (24, 896, 14, 2, 64, 4864,
                                                151936)


# --------------------------- refusals and the CLI ---------------------------


def test_convert_refuses_an_unconsumed_leaf(ref):
    cfg = config_from_jax(json.loads(str(ref["smoke__cfg"])))
    params = {k[len("smoke__p__"):]: v for k, v in ref.items()
              if k.startswith("smoke__p__")}
    state_dict_from_jax(params, cfg)
    with pytest.raises(ValueError, match="does not consume.*blocks/extra"):
        state_dict_from_jax(dict(params, **{"blocks/extra": np.zeros(2)}),
                            cfg)
    del params["final_norm/scale"]
    with pytest.raises(KeyError, match="final_norm/scale"):
        state_dict_from_jax(params, cfg)


def test_config_refusals():
    with pytest.raises(NotImplementedError, match="item 12d"):
        get_config("qwen2-7b")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-9")
    with pytest.raises(ValueError, match="attention_impl"):
        LMConfig("x", 1, 8, 2, 1, 16, 32, attention_impl="pallas")
    # the MoE path is ported: an MoE config builds MoE blocks
    moe = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                              moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=8))
    model = build_defs(moe, device="cpu")
    assert len(model.moe_blocks) == moe.n_layers
    assert not hasattr(model, "blocks")


def test_serve_lm_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve_lm() runs there")
    cfg = get_config("qwen2-0.5b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_lm(cfg, 1, 4, 2)


def test_seeded_weights_are_reproducible():
    cfg = get_config("qwen2-0.5b", reduced=True)
    a, b = (build_defs(cfg, device="cpu", seed=3) for _ in range(2))
    c = build_defs(cfg, device="cpu", seed=4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(("weight", "embed")):
            assert not torch.equal(pa, pc), name
    w = a.blocks[0].ffn.down.weight  # [d, d_ff]: std 1/sqrt(d_ff)
    assert abs(float(w.detach().std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    assert abs(float(a.embed.detach().std()) / 0.02 - 1.0) < 0.05


def test_cli_runs_the_smoke_config_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--prompt-len", "8", "--decode-steps",
                "3"])
    out = capsys.readouterr().out
    assert "prefill: 2x8" in out and "decode:" in out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_build_defs_defaults_to_the_card(arch):
    """``build_defs`` and ``LM`` take ``device=None`` as the card: without
    one they raise, naming ``device="cpu"``, which builds on the CPU."""
    cfg = get_config(arch, reduced=True)
    for model in (build_defs(cfg, device="cpu"), T.LM(cfg, device="cpu")):
        assert {p.device.type for p in model.parameters()} == {"cpu"}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gpu test checks the default")
    for build in (build_defs, T.LM):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(cfg)


# ------------------------------- on the card --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: prefill attention runs the CUDA "
                    "kernel, which has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_serve_on_the_card_goes_through_the_kernel(cuda):
    cfg = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                              attention_impl="cuda")
    model = build_defs(cfg, device=cuda)
    reset_launch_counts()
    out = serve.serve_lm(cfg, 2, 100, 4, model=model)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    tokens = serve.prompt_tokens(cfg, 2, 100).to(cuda)
    plain, _ = T.prefill(model, tokens,
                         dataclasses.replace(cfg, attention_impl="torch"))
    torch.testing.assert_close(out.last_logits, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_build_defs_default_lands_on_the_card(cuda, arch):
    cfg = get_config(arch, reduced=True)
    for model in (build_defs(cfg), T.LM(cfg)):
        assert {p.device.type for p in model.parameters()} == {"cuda"}
