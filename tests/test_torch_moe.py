"""The port's MoE routers and MoE layer against the JAX package, on the CPU.

The JAX side runs once per module in a child process
(``test_torch_harness.run_reference``); the inputs are made with numpy
from seeds and handed to both sides. Every router's integer outputs
(experts, slots, keep) must be identical, and its weights equal up to the
rounding of two softmax implementations (rtol 1e-6):

  - ``topk_route``: normal and bf16-rounded logits, a capacity that drops
    tokens, and all-equal logits, where ``torch.topk`` returns tied entries
    out of index order and ``jax.lax.top_k`` (and the port) in order;
  - ``balanced_assign_batched`` and ``swap_improve_batched`` (the swap
    search through K4's entry and through the dense plain version): normal,
    bf16-rounded and ``-1e6``-penalised affinities, capacity 1, and the
    decode shape, 4 real tokens and 56 all-zero padded ones over 60
    experts;
  - ``awpm_route_batched`` on the same kinds of input;
  - ``matching_route_batched`` over the port's ``solve()``;
  - ``moe_apply`` in float32 under both routers (several dispatch groups,
    padded AWPM blocks), within 1e-5, and an AWPM layer routed through
    the 1x1 grid (``dist_spec``) against JAX's shard_map route.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import make_grid  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

W_TOL = 1e-6
Y_TOL = 1e-5

#: name -> (T, E, k, capacity) of the topk_route cases
TOPK = {"tk_normal": (64, 8, 2, 24), "tk_drop": (64, 8, 2, 10),
        "tk_bf16": (64, 8, 2, 10), "tk_uniform": (16, 6, 4, 8)}
#: name -> (G, T, E) of the balanced-assign / swap / awpm cases
ROUTE = {"r_normal": (3, 64, 8), "r_bf16": (3, 64, 8), "r_pen": (2, 60, 6),
         "r_cap1": (2, 8, 8), "r_decode": (1, 60, 60)}
AWPM_K, SWAP_ROUNDS = 3, 4
MATCH = {"m_normal": (2, 12, 4), "m_bf16": (2, 12, 4)}
MATCH_K = 2
#: name -> (router, MoECfg fields replaced) of the moe_apply cases
LAYER = {"awpm_block": ("awpm", dict(router_block=16)),
         "awpm_global": ("awpm", {}),
         "topk_global": ("topk", {}),
         "topk_groups": ("topk", dict(dispatch_groups=2))}
X_SHAPE = (2, 40, 64)

REFERENCE = """
import dataclasses

import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.models import moe as M
from repro.models.param import init_params

TOPK = %(topk)r
ROUTE = %(route)r
MATCH = %(match)r
LAYER = %(layer)r

for name, (t, e, k, cap) in TOPK.items():
    out = M.topk_route(jnp.asarray(IN[name]), k, cap)
    for key, v in zip(("topi", "slot", "w", "keep", "aux"), out):
        OUT[f"{name}__{key}"] = v

for name, (g, t, e) in ROUTE.items():
    aff = jnp.asarray(IN[name])
    cap = t // e
    a = M.balanced_assign_batched(aff, cap)
    OUT[name + "__balanced"] = a
    OUT[name + "__swapped"] = M.swap_improve_batched(aff, a, %(rounds)d)
    out = M.awpm_route_batched(aff, min(%(k)d, e), cap, %(rounds)d)
    for key, v in zip(("topi", "slot", "w"), out):
        OUT[f"{name}__awpm_{key}"] = v

for name, (g, t, e) in MATCH.items():
    out = M.matching_route_batched(jnp.asarray(IN[name]), %(mk)d, t // e)
    for key, v in zip(("topi", "slot", "w"), out):
        OUT[f"{name}__{key}"] = v

for name, (router, fields) in LAYER.items():
    cfg = get_config("qwen2-moe-a2.7b", reduced=True, router=router)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **fields))
    params = init_params(M.moe_def(cfg, cfg.moe), jax.random.PRNGKey(3))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        key = "/".join(p.key for p in path)
        OUT[f"{name}__p__{key}"] = leaf
    y, aux = M.moe_apply(params, jnp.asarray(IN["x"]), cfg, cfg.moe)
    OUT[name + "__y"], OUT[name + "__aux"] = y, aux
    if name == "awpm_block":  # routed through the 1x1 grid's engine
        from repro.core.dist import GridSpec, make_mesh
        y, _ = M.moe_apply(params, jnp.asarray(IN["x"]), cfg, cfg.moe,
                           dist_spec=GridSpec(make_mesh((1, 1))))
        OUT[name + "__y_grid"] = y
""" % dict(topk=TOPK, route=ROUTE, match=MATCH, layer=LAYER,
           rounds=SWAP_ROUNDS, k=AWPM_K, mk=MATCH_K)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs():
    out = {}
    for i, (name, (t, e, _, _)) in enumerate(TOPK.items()):
        x = np.random.default_rng(10 + i).normal(size=(t, e))
        out[name] = (_bf16(x.astype(np.float32)) if name == "tk_bf16"
                     else np.zeros((t, e)) if name == "tk_uniform"
                     else x).astype(np.float32)
    for i, (name, (g, t, e)) in enumerate(ROUTE.items()):
        rng = np.random.default_rng(20 + i)
        x = rng.normal(size=(g, t, e)).astype(np.float32)
        if name in ("r_bf16", "r_decode"):
            x = _bf16(x)
        if name == "r_pen":
            x = np.where(rng.random((g, t, e)) < 0.4, x - 1e6, x)
        if name == "r_decode":
            x[:, 4:] = 0.0  # a decode step: 4 tokens padded to 60
        out[name] = x.astype(np.float32)
    for i, (name, shape) in enumerate(MATCH.items()):
        x = np.random.default_rng(30 + i).normal(size=shape)
        out[name] = (_bf16(x.astype(np.float32)) if name == "m_bf16"
                     else x).astype(np.float32)
    out["x"] = np.random.default_rng(40).normal(size=X_SHAPE).astype(
        np.float32)
    return out


INPUTS = _inputs()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE, INPUTS, tmp_path_factory.mktemp("moe"))


def _t(name):
    return torch.from_numpy(INPUTS[name])


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------- routers ------------------------------------


@pytest.mark.parametrize("name", list(TOPK))
def test_topk_route_matches_jax(ref, name):
    _, _, k, cap = TOPK[name]
    topi, slot, w, keep, aux = M.topk_route(_t(name), k, cap)
    _same(topi, ref[name + "__topi"])
    _same(slot, ref[name + "__slot"])
    _same(keep, ref[name + "__keep"])
    np.testing.assert_allclose(w.numpy(), ref[name + "__w"], rtol=W_TOL,
                               atol=W_TOL)
    np.testing.assert_allclose(float(aux), float(ref[name + "__aux"]),
                               rtol=W_TOL)
    if name == "tk_drop":
        assert not bool(keep.all())


def test_uniform_logits_defeat_torch_topk(ref):
    """The case ``tk_uniform`` is one that ``torch.topk`` gets wrong: its
    tied entries come out of index order, JAX's and the port's in order."""
    probs = torch.softmax(_t("tk_uniform"), dim=-1)
    assert not np.array_equal(torch.topk(probs, 4).indices.numpy(),
                              ref["tk_uniform__topi"])
    np.testing.assert_array_equal(ref["tk_uniform__topi"][0], [0, 1, 2, 3])


@pytest.mark.parametrize("name", list(ROUTE))
def test_balanced_assign_matches_jax(ref, name):
    g, t, e = ROUTE[name]
    a = M.balanced_assign_batched(_t(name), t // e)
    _same(a, ref[name + "__balanced"])
    loads = torch.stack([torch.bincount(x, minlength=e) for x in a])
    assert bool((loads == t // e).all())
    _same(M.balanced_assign(_t(name)[0], t // e), ref[name + "__balanced"][0])


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel_route", "dense_route"])
@pytest.mark.parametrize("name", list(ROUTE))
def test_swap_improve_matches_jax(ref, name, use_kernel):
    a0 = torch.from_numpy(ref[name + "__balanced"])
    got = M.swap_improve_batched(_t(name), a0, SWAP_ROUNDS,
                                 use_kernel=use_kernel)
    _same(got, ref[name + "__swapped"])
    one = M.swap_improve(_t(name)[0], a0[0], SWAP_ROUNDS,
                         use_kernel=use_kernel)
    _same(one, ref[name + "__swapped"][0])


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel_route", "dense_route"])
@pytest.mark.parametrize("name", list(ROUTE))
def test_awpm_route_matches_jax(ref, name, use_kernel):
    g, t, e = ROUTE[name]
    topi, slot, w, keep, aux = M.awpm_route_batched(
        _t(name), min(AWPM_K, e), t // e, SWAP_ROUNDS, use_kernel=use_kernel)
    _same(topi, ref[name + "__awpm_topi"])
    _same(slot, ref[name + "__awpm_slot"])
    np.testing.assert_allclose(w.numpy(), ref[name + "__awpm_w"], rtol=W_TOL,
                               atol=W_TOL)
    assert bool(keep.all()) and float(aux) == 0.0
    one = M.awpm_route(_t(name)[0], min(AWPM_K, e), t // e, SWAP_ROUNDS,
                       use_kernel=use_kernel)
    _same(one[0], ref[name + "__awpm_topi"][0])


@pytest.mark.parametrize("name", list(MATCH))
def test_matching_route_matches_jax(ref, name):
    g, t, e = MATCH[name]
    topi, slot, w, keep, _ = M.matching_route_batched(_t(name), MATCH_K,
                                                      t // e)
    _same(topi, ref[name + "__topi"])
    _same(slot, ref[name + "__slot"])
    np.testing.assert_allclose(w.numpy(), ref[name + "__w"], rtol=W_TOL,
                               atol=W_TOL)
    assert bool(keep.all())


def test_matching_route_refusals():
    lg = _t("m_normal")
    with pytest.raises(ValueError, match="GridSpec"):
        M.matching_route_batched(lg, 2, 3, dist_spec=object())
    with pytest.raises(ValueError, match="slots"):
        M.matching_route_batched(lg, 2, 4)
    with pytest.raises(ValueError, match="capacity"):
        M.balanced_assign_batched(lg, 4)


def test_router_stats():
    lg = _t("tk_normal")
    topi = M.topk_route(lg, 2, 24)[0]
    st = M.router_stats(lg, topi, 8)
    assert int(st["load"].sum()) == 64 * 2
    want = np.bincount(topi.numpy().ravel(), minlength=8)
    np.testing.assert_array_equal(st["load"].numpy(), want)
    np.testing.assert_allclose(float(st["load_cv"]), want.std() / want.mean(),
                               rtol=1e-6)


# ------------------------------- the layer ----------------------------------


def _layer(ref, name):
    router, fields = LAYER[name]
    cfg = get_config("qwen2-moe-a2.7b", reduced=True, router=router)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **fields))
    p = M.MoE(cfg, cfg.moe)
    prefix = name + "__p__"
    flat = {k[len(prefix):]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith(prefix)}
    state = {"router.weight": flat.pop("router/w").T}
    for w in ("gate", "up", "down"):
        state[f"experts.{w}"] = flat.pop(f"experts/{w}")
        state[f"shared.{w}.weight"] = flat.pop(f"shared/{w}/w").T
    state["shared_gate.weight"] = flat.pop("shared_gate/w").T
    assert not flat
    p.load_state_dict(state)
    return p, cfg


@pytest.mark.parametrize("name", list(LAYER))
def test_moe_apply_matches_jax(ref, name):
    p, cfg = _layer(ref, name)
    with torch.no_grad():
        y, aux = M.moe_apply(p, _t("x"), cfg, cfg.moe)
    assert y.shape == X_SHAPE and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref[name + "__y"], rtol=Y_TOL,
                               atol=Y_TOL)
    np.testing.assert_allclose(float(aux), float(ref[name + "__aux"]),
                               rtol=Y_TOL, atol=1e-9)
    if cfg.moe.router == "topk":
        assert float(aux) > 0


def test_moe_apply_with_dist_spec_needs_the_grid_engine(ref):
    p, cfg = _layer(ref, "awpm_block")
    with pytest.raises(ValueError, match="GridSpec"):
        M.moe_apply(p, _t("x"), cfg, cfg.moe, dist_spec=object())
    with torch.no_grad():
        y, aux = M.moe_apply(p, _t("x"), cfg, cfg.moe,
                             dist_spec=make_grid(1, 1, device="cpu"))
    np.testing.assert_allclose(y.numpy(), ref["awpm_block__y_grid"],
                               rtol=Y_TOL, atol=Y_TOL)
    assert float(aux) == 0.0
