"""The port's MoE LM serving path against the JAX package, on the CPU.

The JAX side runs once per module in a child process
(``test_torch_harness.run_reference``) with ``attention_impl="pallas"``
(the Pallas kernel, interpreted); its weights (``init_params`` from
``PRNGKey(0)``) are carried across with ``models.convert``, which maps
"pallas" to "cuda": on CPU tensors the port's kernel wrappers (K5, and K4
in the AWPM router's swap search) take their plain versions.

  - ``qwen2-moe-a2.7b-smoke`` in float32 under both routers (``awpm`` and
    ``topk``): ``forward``'s logits and aux loss, ``prefill``'s last logits
    and cache (group ``moe_blocks``), three ``decode_step``s (logits and
    cache), at rtol/atol 1e-4 (float32 products summed in another order in
    two frameworks, over two layers); ``serve_lm``'s ids, identical;
  - ``deepseek-moe-16b-smoke`` (a leading dense layer: the cache groups
    ``dense_blocks`` and ``moe_blocks``): forward and prefill, both routers;
  - two layers at qwen2-moe-a2.7b's own widths (d_model 2048, 16 heads, 16
    kv heads, head_dim 128, 60 experts, top-4) with narrow experts (16)
    and shared experts (64) and a 512-token vocabulary, AWPM router:
    forward and prefill;
  - the registry against the JAX configs, the converter's MoE tree and its
    refusals.

The ``gpu`` test serves the smoke model on the card and skips here.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_defs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    config_from_jax,
    state_dict_from_jax,
)
from test_torch_harness import run_reference  # noqa: E402

S = 128  # the Pallas kernel takes multiples of its 128-row tile
DECODE = 3
SERVE = dict(batch=2, prompt_len=128, decode_steps=8)
MODELS = ("qwen_awpm", "qwen_topk", "deepseek_awpm", "deepseek_topk",
          "geom_awpm")
SERVED = ("qwen_awpm", "qwen_topk")
TOL = 1e-4

REFERENCE = """
import dataclasses
import json

import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.configs.qwen2_moe_a2_7b import config as qwen2_moe
from repro.models import build_defs
from repro.models import transformer as T
from repro.models.param import init_params

SERVED = %(served)r


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def pallas(cfg):
    return dataclasses.replace(cfg, attention_impl="pallas")


geom = qwen2_moe(router="awpm")
geom = dataclasses.replace(
    geom, n_layers=2, vocab=512, dtype="float32",
    moe=dataclasses.replace(geom.moe, d_ff_expert=16, d_ff_shared=64))
cfgs = {
    "qwen_awpm": get_config("qwen2-moe-a2.7b", reduced=True, router="awpm"),
    "qwen_topk": get_config("qwen2-moe-a2.7b", reduced=True, router="topk"),
    "deepseek_awpm": get_config("deepseek-moe-16b", reduced=True,
                                router="awpm"),
    "deepseek_topk": get_config("deepseek-moe-16b", reduced=True),
    "geom_awpm": geom,
}
for arch in ("qwen2-moe-a2.7b", "deepseek-moe-16b"):
    for reduced in (False, True):
        OUT[f"registry__{arch}__{reduced}"] = json.dumps(dataclasses.asdict(
            get_config(arch, reduced=reduced, router="awpm")))

for name, cfg in cfgs.items():
    cfg = pallas(cfg)
    params = init_params(build_defs(cfg), jax.random.PRNGKey(0))
    OUT.update({f"{name}__p__{k}": v for k, v in flat(params).items()})
    OUT[name + "__cfg"] = json.dumps(dataclasses.asdict(cfg))
    tokens = jnp.asarray(IN[name + "__tokens"])
    logits, aux, _ = T.forward(params, tokens, cfg)
    OUT[name + "__logits"], OUT[name + "__aux"] = logits, aux
    last, cache = T.prefill(params, tokens, cfg)
    OUT[name + "__last"] = last
    for group, (k, v) in cache.items():
        OUT[f"{name}__cache__{group}__k"] = k
        OUT[f"{name}__cache__{group}__v"] = v
    if name not in SERVED:
        continue
    s, nd = tokens.shape[1], int(IN["decode"])
    pad = ((0, 0), (0, 0), (0, nd), (0, 0), (0, 0))
    cache = {g: (jnp.pad(k, pad), jnp.pad(v, pad))
             for g, (k, v) in cache.items()}
    tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
    for i in range(nd):
        OUT[f"{name}__decode{i}__tok"] = tok
        lg, cache = T.decode_step(params, cache, tok, s + i, cfg)
        OUT[f"{name}__decode{i}__logits"] = lg
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    OUT[name + "__decode__k"], OUT[name + "__decode__v"] = \\
        cache["moe_blocks"]

    # launch/serve.py's serve_lm, which prints its ids and returns nothing
    batch, plen, steps = (int(x) for x in IN["serve"])
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab, (batch, plen)), jnp.int32)
    smax = plen + steps
    logits, cache = T.prefill(params, tokens, cfg)

    def grow(kv):
        k, v = kv
        kb = jnp.zeros((k.shape[0], batch, smax, *k.shape[3:]), k.dtype)
        return (kb.at[:, :, :plen].set(k),
                jnp.zeros_like(kb).at[:, :, :plen].set(v))

    cache = {g: grow(kv) for g, kv in cache.items()}
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(steps - 1):
        lg, cache = T.decode_step(params, cache, tok, plen + i, cfg)
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    OUT[name + "__serve__ids"] = jnp.concatenate(out, 1)
""" % dict(served=SERVED)


def _tokens(name):
    rng = np.random.default_rng(MODELS.index(name) + 1)
    return rng.integers(0, 512, (2, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = dict(decode=np.array(DECODE),
                  serve=np.array([SERVE["batch"], SERVE["prompt_len"],
                                  SERVE["decode_steps"]]))
    for name in MODELS:
        inputs[name + "__tokens"] = _tokens(name)
    return run_reference(REFERENCE, inputs, tmp_path_factory.mktemp("moe_lm"))


def _params(ref, name):
    prefix = f"{name}__p__"
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def _port_model(ref, name):
    cfg = config_from_jax(json.loads(str(ref[name + "__cfg"])))
    model = build_defs(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(_params(ref, name), cfg))
    return model, cfg


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(ref, name):
    model, cfg = _port_model(ref, name)
    assert cfg.attention_impl == "cuda"
    logits, aux, cache = T.forward(model, torch.from_numpy(_tokens(name)), cfg)
    assert logits.dtype == torch.float32 and cache is None
    _close(logits, ref[name + "__logits"])
    np.testing.assert_allclose(float(aux), float(ref[name + "__aux"]),
                               rtol=TOL, atol=1e-9)
    assert (float(aux) > 0) == (cfg.moe.router == "topk")


@pytest.mark.parametrize("name", MODELS)
def test_prefill_matches_jax(ref, name):
    model, cfg = _port_model(ref, name)
    last, cache = T.prefill(model, torch.from_numpy(_tokens(name)), cfg)
    _close(last, ref[name + "__last"])
    shapes = T.cache_shapes(cfg, 2, S)
    groups = {k.split("__")[2] for k in ref
              if k.startswith(f"{name}__cache__")}
    assert set(cache) == set(shapes) == groups
    want = ["moe_blocks"] + (["dense_blocks"] if cfg.moe.first_dense else [])
    assert sorted(cache) == sorted(want)
    for group, (k, v) in cache.items():
        (shape, dtype), _ = shapes[group]
        assert k.shape == v.shape == shape and k.dtype == dtype
        _close(k, ref[f"{name}__cache__{group}__k"])
        _close(v, ref[f"{name}__cache__{group}__v"])


@pytest.mark.parametrize("name", SERVED)
def test_decode_steps_match_jax(ref, name):
    model, cfg = _port_model(ref, name)
    _, cache = T.prefill(model, torch.from_numpy(_tokens(name)), cfg)
    pad = (0, 0, 0, 0, 0, DECODE)
    cache = {g: tuple(torch.nn.functional.pad(x, pad) for x in kv)
             for g, kv in cache.items()}
    for i in range(DECODE):
        tok = torch.from_numpy(ref[f"{name}__decode{i}__tok"]).long()
        lg, cache = T.decode_step(model, cache, tok, S + i, cfg)
        _close(lg, ref[f"{name}__decode{i}__logits"])
    _close(cache["moe_blocks"][0], ref[name + "__decode__k"])
    _close(cache["moe_blocks"][1], ref[name + "__decode__v"])


@pytest.mark.parametrize("name", SERVED)
def test_serve_lm_ids_match_jax(ref, name, capsys):
    model, cfg = _port_model(ref, name)
    out = serve.serve_lm(cfg, **SERVE, device="cpu", model=model)
    np.testing.assert_array_equal(out.ids.numpy(), ref[name + "__serve__ids"])
    assert "prefill:" in capsys.readouterr().out


def test_grow_cache_keeps_every_group(ref):
    model, cfg = _port_model(ref, "deepseek_awpm")
    _, cache = T.prefill(model, torch.from_numpy(_tokens("deepseek_awpm")),
                         cfg)
    grown = serve.grow_cache(cache, cfg, S + 4)
    assert set(grown) == {"dense_blocks", "moe_blocks"}
    for group, kv in grown.items():
        for big, small in zip(kv, cache[group]):
            assert big.shape[2] == S + 4
            assert torch.equal(big[:, :, :S], small)
            assert not bool(big[:, :, S:].any())


# ------------------------- registry and converter ---------------------------


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-moe-16b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_registry_copies_the_jax_configs(ref, arch, reduced):
    want = config_from_jax(json.loads(str(
        ref[f"registry__{arch}__{reduced}"])))
    assert get_config(arch, reduced=reduced, router="awpm") == want
    assert get_config(arch, reduced=reduced).moe.router == "topk"


def test_registry_full_widths():
    cfg = get_config("qwen2-moe-a2.7b", router="awpm")
    md = cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.vocab, cfg.qkv_bias, cfg.tie_embeddings) == (
        24, 2048, 16, 16, 128, 151936, True, False)
    assert (md.n_experts, md.top_k, md.d_ff_expert, md.n_shared,
            md.d_ff_shared, md.shared_gate, md.router, md.router_block,
            md.router_swap_rounds) == (60, 4, 1408, 4, 5632, True, "awpm",
                                       2048, 4)


def test_convert_moe_tree_and_refusals(ref):
    name = "deepseek_awpm"
    cfg = config_from_jax(json.loads(str(ref[name + "__cfg"])))
    params = _params(ref, name)
    sd = state_dict_from_jax(params, cfg)
    # experts keep JAX's [E, in, out]; dense weights turn to [out, in]
    np.testing.assert_array_equal(sd["moe_blocks.1.ffn.experts.down"].numpy(),
                                  params["moe_blocks/ffn/experts/down"][1])
    np.testing.assert_array_equal(sd["moe_blocks.0.ffn.router.weight"].numpy(),
                                  params["moe_blocks/ffn/router/w"][0].T)
    np.testing.assert_array_equal(sd["dense_blocks.0.ffn.gate.weight"].numpy(),
                                  params["dense_blocks/ffn/gate/w"][0].T)
    model = build_defs(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    for extra in ("moe_blocks/ffn/extra", "moe_blocks/ffn/shared_gate/b",
                  "blocks/ln1/scale"):
        with pytest.raises(ValueError, match="does not consume"):
            state_dict_from_jax(dict(params, **{extra: np.zeros(2)}), cfg)
    short = dict(params)
    del short["moe_blocks/ffn/router/w"]
    with pytest.raises(KeyError, match="moe_blocks/ffn/router/w"):
        state_dict_from_jax(short, cfg)
    short = dict(params, **{"dense_blocks/ln1/scale":
                            params["dense_blocks/ln1/scale"][:0]})
    with pytest.raises(ValueError, match="0 layers stacked"):
        state_dict_from_jax(short, cfg)


def test_moe_weights_are_drawn_with_the_jax_distributions():
    cfg = get_config("qwen2-moe-a2.7b", reduced=True, router="awpm")
    model = build_defs(cfg, device="cpu", seed=1)
    ffn = model.moe_blocks[0].ffn
    assert ffn.experts.gate.shape == (6, 64, 32)
    assert ffn.experts.down.shape == (6, 32, 64)
    assert ffn.router.weight.shape == (6, 64)
    assert ffn.shared_gate.weight.shape == (1, 64)
    w = torch.cat([b.ffn.experts.down.detach().reshape(-1)
                   for b in model.moe_blocks])
    assert abs(float(w.std()) * np.sqrt(32) - 1.0) < 0.05


# ------------------------------- on the card --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the router's swap search and the "
                    "prefill attention run CUDA kernels, which have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("router", ["awpm", "topk"])
def test_moe_serve_on_the_card_matches_the_cpu(cuda, router):
    import copy

    cfg = dataclasses.replace(
        get_config("qwen2-moe-a2.7b", reduced=True, router=router),
        attention_impl="cuda")
    m_cpu = build_defs(cfg, device="cpu", seed=0)
    m_gpu = copy.deepcopy(m_cpu).to(cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    r_gpu = serve.serve_lm(cfg, 2, 128, 6, device=cuda, model=m_gpu)
    counts = launch_counts()
    r_cpu = serve.serve_lm(cfg, 2, 128, 6, device="cpu", model=m_cpu)
    assert torch.equal(r_gpu.ids.cpu(), r_cpu.ids)
    torch.testing.assert_close(r_gpu.last_logits.cpu(), r_cpu.last_logits,
                               rtol=1e-4, atol=1e-4)
    md = cfg.moe
    per_step = cfg.n_layers * md.top_k * md.router_swap_rounds
    assert counts["router_swap"] == (per_step * 6 if router == "awpm" else 0)
    assert counts["flash_attention"] == cfg.n_layers
