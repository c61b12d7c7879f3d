"""The port's recsys serving path (bert4rec) against the JAX package, on
the CPU.

The JAX side runs once per module in a child process
(``test_torch_harness.run_reference``); its weights (``init_params`` from
``PRNGKey(0)``, as the JAX example draws them) are carried across to the
port with ``models.convert``:

  - ``layernorm`` and ``gelu_mlp`` against JAX at rtol = atol = 1e-6, and
    a check that the tolerance catches the traps: the erf GELU
    (``jax.nn.gelu`` is the tanh approximation) and ``F.layer_norm``
    (another eps) both miss it;
  - ``bert4rec-smoke`` and bert4rec at its published widths and sequence
    length with its item table cut to 2,000 items: the hidden states at
    1e-5, ``serve_scores`` and ``retrieval_scores`` at 1e-4 (float32
    products summed in another order in two frameworks, over two blocks),
    and the top items identical;
  - ``serve_recsys`` against the JAX example's serving code
    (``examples/serve_bert4rec.py``) on the example's draws, with the
    candidate set of the ``retrieval_cand`` cell (every item of the smoke
    catalogue, where the example takes 400): the same top items and
    top-5 candidates;
  - the config registry, the parameter count of the published config
    (65,142,016, counted from ``bert4rec_def``), the converter's
    refusals, and the launcher's refusal to fall back to the CPU.

The ``gpu`` tests serve on the card and skip here.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_defs  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    bert4rec_state_dict_from_jax,
    recsys_config_from_jax,
)
from repro_torch.models.layers import GeluMLP, layernorm  # noqa: E402
from repro_torch.models.param import count_params  # noqa: E402
from repro_torch.models.recsys import embedding  # noqa: E402
from repro_torch.models.recsys.bert4rec import Bert4Rec  # noqa: E402
from repro_torch.models.recsys.embedding import embedding_bag  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

LAYER_TOL = 1e-6
HIDDEN_TOL = 1e-5
SCORE_TOL = 1e-4
MODELS = ("smoke", "geom")
BATCH = 4
N_CANDIDATES = 300
EXAMPLE = dict(batch=32, n_candidates=500)  # all of bert4rec-smoke's items
FULL_PARAMS = 65_142_016

REFERENCE = """
import dataclasses
import json

import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.configs.bert4rec import config as bert4rec_full
from repro.models import build_defs
from repro.models.layers import gelu_mlp, layernorm
from repro.models.param import count_params, init_params
from repro.models.recsys import bert4rec


def flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


x = jnp.asarray(IN["x"])
OUT["layernorm"] = layernorm({"scale": IN["ln_scale"], "bias": IN["ln_bias"]},
                             x)
OUT["gelu_mlp"] = gelu_mlp({n: {"w": IN[n + "_w"], "b": IN[n + "_b"]}
                            for n in ("up", "down")}, x)
OUT["full__cfg"] = json.dumps(dataclasses.asdict(bert4rec_full()))
OUT["full__count"] = count_params(build_defs(bert4rec_full()))

smoke = get_config("bert4rec", reduced=True)
geom = dataclasses.replace(bert4rec_full(), n_items=2000)
for name, cfg in (("smoke", smoke), ("geom", geom)):
    params = init_params(build_defs(cfg), jax.random.PRNGKey(0))
    OUT[name + "__blocks_is_list"] = isinstance(params["blocks"], list)
    OUT.update({f"{name}__p__{k}": v for k, v in flat(params).items()})
    OUT[name + "__cfg"] = json.dumps(dataclasses.asdict(cfg))
    seqs = jnp.asarray(IN[name + "__seqs"])
    cands = jnp.asarray(IN[name + "__cands"])
    OUT[name + "__hidden"] = bert4rec.encode(params, seqs, cfg)
    OUT[name + "__scores"] = bert4rec.serve_scores(params, seqs, cfg)
    OUT[name + "__retrieval"] = bert4rec.retrieval_scores(params, seqs[:1],
                                                          cands, cfg)
    if name != "smoke":
        continue
    # examples/serve_bert4rec.py's draws and outputs, with 500 candidates
    rng = np.random.default_rng(0)
    batch = jnp.asarray(rng.integers(0, cfg.n_items, (32, cfg.seq_len)),
                        jnp.int32)
    scores = bert4rec.serve_scores(params, batch, cfg)
    OUT["example__top"] = jnp.argmax(scores, axis=-1)
    cands = jnp.asarray(rng.choice(cfg.n_items, 500, replace=False),
                        jnp.int32)
    r = bert4rec.retrieval_scores(params, batch[:1], cands, cfg)
    OUT["example__best"] = np.array(cands)[np.argsort(-np.array(r[0]))[:5]]
"""


def _layer_inputs():
    rng = np.random.default_rng(3)
    d, hidden = 64, 256

    def w(fan_in, shape):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return {
        "x": rng.normal(size=(2, 8, d)).astype(np.float32),
        "ln_scale": (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32),
        "ln_bias": (0.1 * rng.normal(size=d)).astype(np.float32),
        "up_w": w(d, (d, hidden)), "up_b": w(1, hidden) * 0.1,
        "down_w": w(hidden, (hidden, d)), "down_b": w(1, d) * 0.1,
    }


LAYERS = _layer_inputs()


def _requests(name):
    n_items, seq_len = {"smoke": (500, 16), "geom": (2000, 200)}[name]
    rng = np.random.default_rng({"smoke": 1, "geom": 2}[name])
    seqs = rng.integers(0, n_items, (BATCH, seq_len)).astype(np.int32)
    cands = rng.choice(n_items, N_CANDIDATES, replace=False).astype(np.int32)
    return seqs, cands


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = dict(LAYERS)
    for name in MODELS:
        inputs[name + "__seqs"], inputs[name + "__cands"] = _requests(name)
    return run_reference(REFERENCE, inputs, tmp_path_factory.mktemp("rec"))


def _params(ref, name):
    prefix = f"{name}__p__"
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _port_model(ref, name):
    cfg = recsys_config_from_jax(json.loads(str(ref[name + "__cfg"])))
    model = build_defs(cfg, device="cpu")
    model.load_state_dict(bert4rec_state_dict_from_jax(_params(ref, name),
                                                       cfg))
    return model, cfg


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _port_mlp():
    mlp = GeluMLP(64, 256)
    with torch.no_grad():
        for n in ("up", "down"):
            getattr(mlp, n).weight.copy_(torch.from_numpy(LAYERS[n + "_w"].T))
            getattr(mlp, n).bias.copy_(torch.from_numpy(LAYERS[n + "_b"]))
    return mlp


# ------------------------------- layers -------------------------------------


def test_layernorm_matches_jax(ref):
    got = layernorm(torch.from_numpy(LAYERS["ln_scale"]),
                    torch.from_numpy(LAYERS["ln_bias"]),
                    torch.from_numpy(LAYERS["x"]))
    _close(got, ref["layernorm"], LAYER_TOL)


def test_gelu_mlp_matches_jax(ref):
    with torch.no_grad():
        got = _port_mlp()(torch.from_numpy(LAYERS["x"]))
    _close(got, ref["gelu_mlp"], LAYER_TOL)


@pytest.mark.parametrize("trap", ["erf_gelu", "torch_layer_norm"])
def test_the_tolerance_catches_the_traps(ref, trap):
    """The two look-alikes the port must not use differ from JAX by more
    than the layers' tolerance, so the tests above would fail with them."""
    x = torch.from_numpy(LAYERS["x"])
    with torch.no_grad():
        if trap == "erf_gelu":
            mlp = _port_mlp()
            got, want = mlp.down(F.gelu(mlp.up(x))), ref["gelu_mlp"]
        else:
            got = F.layer_norm(x, (64,), torch.from_numpy(LAYERS["ln_scale"]),
                               torch.from_numpy(LAYERS["ln_bias"]))
            want = ref["layernorm"]
    with pytest.raises(AssertionError):
        _close(got, want, LAYER_TOL)


# ------------------------------- bert4rec -----------------------------------


def test_jax_keeps_the_blocks_as_a_list(ref):
    assert bool(ref["smoke__blocks_is_list"])
    assert "smoke__p__blocks/1/ffn/down/w" in ref


@pytest.mark.parametrize("name", MODELS)
def test_hidden_matches_jax(ref, name):
    model, _ = _port_model(ref, name)
    seqs, _ = _requests(name)
    _close(model.encode(torch.from_numpy(seqs)), ref[name + "__hidden"],
           HIDDEN_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_serve_scores_match_jax(ref, name):
    model, cfg = _port_model(ref, name)
    seqs, _ = _requests(name)
    got = model.serve_scores(torch.from_numpy(seqs))
    want = ref[name + "__scores"]
    assert tuple(got.shape) == (BATCH, cfg.padded_items)
    _close(got, want, SCORE_TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("name", MODELS)
def test_retrieval_scores_match_jax(ref, name):
    model, _ = _port_model(ref, name)
    seqs, cands = _requests(name)
    got = model.retrieval_scores(torch.from_numpy(seqs[:1]),
                                 torch.from_numpy(cands))
    want = ref[name + "__retrieval"]
    assert tuple(got.shape) == (1, N_CANDIDATES)
    _close(got, want, SCORE_TOL)
    np.testing.assert_array_equal(
        torch.argsort(got[0], descending=True)[:10].numpy(),
        np.argsort(-want[0], kind="stable")[:10])


def test_serve_recsys_matches_the_jax_example(ref, capsys):
    model, cfg = _port_model(ref, "smoke")
    out = serve.serve_recsys(cfg, EXAMPLE["batch"], device="cpu", model=model)
    np.testing.assert_array_equal(out.top_items.numpy(), ref["example__top"])
    np.testing.assert_array_equal(out.retrieval_top.numpy(),
                                  ref["example__best"])
    assert tuple(out.scores.shape) == (32, cfg.padded_items)
    assert tuple(out.retrieval.shape) == (1, EXAMPLE["n_candidates"])
    printed = capsys.readouterr().out
    assert "serve: batch=32 seq=16" in printed and "retrieval: 1 user x 500" \
        in printed


def test_registry_copies_the_jax_configs(ref):
    full = json.loads(str(ref["full__cfg"]))
    assert dataclasses.asdict(get_config("bert4rec")) == full
    smoke = json.loads(str(ref["smoke__cfg"]))
    assert dataclasses.asdict(get_config("bert4rec", reduced=True)) == smoke
    cfg = get_config("bert4rec")
    assert cfg.family == "recsys" and cfg.padded_items == 1_000_448


def test_full_config_parameter_count(ref):
    assert int(ref["full__count"]) == FULL_PARAMS
    model = build_defs(get_config("bert4rec"), device="cpu")
    assert count_params(model) == FULL_PARAMS
    assert tuple(model.items.shape) == (1_000_448, 64)


def test_convert_refuses_a_leaf_left_over_or_missing(ref):
    cfg = recsys_config_from_jax(json.loads(str(ref["smoke__cfg"])))
    params = _params(ref, "smoke")
    bert4rec_state_dict_from_jax(params, cfg)
    with pytest.raises(ValueError, match="does not consume.*blocks/0/extra"):
        bert4rec_state_dict_from_jax(
            dict(params, **{"blocks/0/extra": np.zeros(2)}), cfg)
    with pytest.raises(KeyError, match="blocks/2/ln1/scale"):
        bert4rec_state_dict_from_jax(
            params, dataclasses.replace(cfg, n_blocks=3))
    del params["final_ln/bias"]
    with pytest.raises(KeyError, match="final_ln/bias"):
        bert4rec_state_dict_from_jax(params, cfg)


def test_dense_weights_are_transposed(ref):
    model, _ = _port_model(ref, "smoke")
    w = ref["smoke__p__blocks/0/ffn/up/w"]  # JAX [in, out]
    assert tuple(model.blocks[0].ffn.up.weight.shape) == w.T.shape
    assert np.array_equal(model.blocks[0].ffn.up.weight.detach().numpy(), w.T)


def test_serve_recsys_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve_recsys() runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_recsys(get_config("bert4rec", reduced=True), 2)


def test_seeded_weights_are_reproducible():
    cfg = get_config("bert4rec", reduced=True)
    a, b = (build_defs(cfg, device="cpu", seed=3) for _ in range(2))
    c = build_defs(cfg, device="cpu", seed=4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(("weight", "items", "pos")):
            assert not torch.equal(pa, pc), name
    assert float(a.out_bias.detach().abs().max()) == 0.0
    w = a.blocks[0].ffn.down.weight  # [d, 4d]: std 1/sqrt(4d)
    assert abs(float(w.detach().std()) * np.sqrt(4 * cfg.embed_dim) - 1) < 0.1


def test_cli_serves_bert4rec_on_the_cpu(capsys):
    serve.main(["--arch", "bert4rec", "--device", "cpu", "--batch", "3"])
    out = capsys.readouterr().out
    assert "serve: batch=3 seq=16 -> scores (3, 512)" in out
    assert "retrieval: 1 user x 500 candidates" in out


def test_item_table_bags_through_both_branches():
    """The recsys ``embedding_bag`` on a model's own item table, both
    branches (on the CPU the kernel's wrapper takes its plain version)."""
    model = build_defs(get_config("bert4rec", reduced=True), device="cpu")
    seqs, _ = serve.recsys_requests(model.cfg, 6, seed=5)
    idx = torch.where(torch.rand(seqs.shape) < 0.1, -1, seqs)
    w = torch.rand(seqs.shape)
    with torch.no_grad():
        got = embedding_bag(model.items, idx, w, use_kernel=True)
        want = embedding_bag(model.items, idx, w, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_build_defs_defaults_to_the_card():
    """``build_defs`` and ``Bert4Rec`` take ``device=None`` as the card:
    without one they raise, naming ``device="cpu"``, which builds on the
    CPU."""
    cfg = get_config("bert4rec", reduced=True)
    for model in (build_defs(cfg, device="cpu"), Bert4Rec(cfg, device="cpu")):
        assert {p.device.type for p in model.parameters()} == {"cpu"}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gpu test checks the default")
    for build in (build_defs, Bert4Rec):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(cfg)


# ------------------------------- on the card --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_serve_recsys_on_the_card_matches_the_cpu(cuda):
    cfg = get_config("bert4rec", reduced=True)
    cpu = build_defs(cfg, device="cpu", seed=0)
    card = build_defs(cfg, device=cuda, seed=0)
    card.load_state_dict(cpu.state_dict())
    r_card = serve.serve_recsys(cfg, 8, device=cuda, model=card)
    r_cpu = serve.serve_recsys(cfg, 8, device="cpu", model=cpu)
    torch.testing.assert_close(r_card.scores.cpu(), r_cpu.scores,
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    assert torch.equal(r_card.top_items.cpu(), r_cpu.top_items)
    assert torch.equal(r_card.retrieval_top.cpu(), r_cpu.retrieval_top)


@pytest.mark.gpu
def test_item_table_bags_launch_the_kernel_on_the_card(cuda):
    model = build_defs(get_config("bert4rec", reduced=True), device=cuda)
    seqs, _ = serve.recsys_requests(model.cfg, 64, seed=5)
    idx = seqs.to(cuda)
    w = torch.rand(idx.shape, device=cuda)
    reset_launch_counts()
    with torch.no_grad():
        got = embedding.embedding_bag(model.items, idx, w, use_kernel=True)
        torch.cuda.synchronize()
        assert launch_counts()["embedding_bag"] == 1
        want = embedding.embedding_bag(model.items, idx, w, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_build_defs_default_lands_on_the_card(cuda):
    cfg = get_config("bert4rec", reduced=True)
    for model in (build_defs(cfg), Bert4Rec(cfg)):
        assert {p.device.type for p in model.parameters()} == {"cuda"}
