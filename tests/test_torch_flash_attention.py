"""The port's flash attention (K5) against the JAX package, on the CPU,
and the CUDA kernel against its plain version, on the card.

On identical inputs (numpy, seeded; bf16 inputs are the same float32 draw
rounded on each side, which rounds identically):

  - ``attention_plain`` and the kernel-layout wrapper ``flash_attention``
    (which takes the plain version for a CPU tensor) against JAX's Pallas
    ``flash_attention`` (interpreted) and ``attention_ref``, on the shapes
    of ``tests/test_kernels.py`` plus qwen2-0.5b's head geometry (GQA 7:1),
    causal and full, at 2e-5 in float32 and 2e-2 in bf16 (the bars of
    ``tests/test_kernels.py``);
  - a ragged S (not a multiple of the TPU kernel's tile) against
    ``attention_ref``, since the JAX kernel refuses it;
  - bf16 at every head width the kernels take, with Sk != S (longer and
    shorter) and GQA groups 1, 2 and 7, against ``attention_ref``;
  - the model-layout entry ``ops.attention`` [B, S, H, D] against JAX's,
    on contiguous tensors and on non-contiguous views (q, k and v cut
    from one fused [B, S, H + 2 Hkv, D] projection).
  - the kernel path under autograd (``ops.FlashAttention``) against
    JAX's ``custom_vjp`` through ``jax.vjp``: the output and dq, dk, dv
    within the tolerance above times the largest magnitude, float32 and
    bf16, causal and full.

The ``gpu`` tests hold both CUDA kernels (bf16 on the tensor cores,
float32 on the CUDA cores) to the plain version on the card and skip
here; on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_attention.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention,
    attention_plain,
    flash_attention,
)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    HEAD_DIMS,
)
from test_torch_harness import run_reference  # noqa: E402

SHAPES = [  # b, h, hkv, s, d
    (1, 4, 4, 256, 64),
    (2, 8, 2, 256, 64),   # GQA 4:1
    (1, 2, 1, 512, 128),  # MQA
    (1, 14, 2, 128, 64),  # qwen2-0.5b: GQA 7:1
]
RAGGED = (1, 14, 2, 100, 64)
# b, h, hkv, s, sk, d: Sk != S at every head width, GQA groups 1, 2, 7
SK_CASES = [(1, h, 2, s, sk, d) for d in HEAD_DIMS
            for h, s, sk in ((2, 40, 72), (4, 72, 40), (14, 50, 90))]
# the kernel path under autograd: the model layout's shapes
GRAD_SHAPES = [SHAPES[1], SHAPES[3]]
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, h, hkv, s, d):
    rng = np.random.default_rng(b * 1000 + h * 100 + hkv * 10 + s + d)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))


def _key(shape):
    return "x".join(map(str, shape))


def _cotangent(shape):
    """A seeded output cotangent [B, S, H, D] for the model layout."""
    b, h, _, s, d = shape
    rng = np.random.default_rng([7, *shape])
    return rng.normal(size=(b, s, h, d)).astype(np.float32)


def _sk_inputs(b, h, hkv, s, sk, d):
    rng = np.random.default_rng([b, h, hkv, s, sk, d])
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, h, s, d), (b, hkv, sk, d), (b, hkv, sk, d)))


REFERENCE = """
import jax
import jax.numpy as jnp
from repro.kernels.flash_attention import attention_ref, flash_attention
from repro.kernels.flash_attention.ops import attention

for key in IN["keys"]:
    key = str(key)
    q, k, v = IN[key + "__q"], IN[key + "__k"], IN[key + "__v"]
    ragged = int(key.split("x")[3]) % 128 != 0
    for dt in ("float32", "bfloat16"):
        qj, kj, vj = (jnp.asarray(x, getattr(jnp, dt)) for x in (q, k, v))
        for causal in (True, False):
            tag = f"{key}__{dt}__{int(causal)}"
            OUT[tag + "__ref"] = np.asarray(
                attention_ref(qj, kj, vj, causal=causal), np.float32)
            if ragged:
                continue
            OUT[tag + "__flash"] = np.asarray(
                flash_attention(qj, kj, vj, causal=causal, tq=128, tk=128),
                np.float32)
            sw = [jnp.swapaxes(x, 1, 2) for x in (qj, kj, vj)]
            OUT[tag + "__ops"] = np.asarray(
                attention(*sw, causal=causal, use_kernel=True), np.float32)
# the kernel path's gradients: JAX's custom_vjp (the Pallas forward,
# interpreted, and attention_ref's backward) on the model layout
for key in IN["grad_keys"]:
    key = str(key)
    for dt in ("float32", "bfloat16"):
        q, k, v = (jnp.asarray(IN[key + n], getattr(jnp, dt))
                   for n in ("__q", "__k", "__v"))
        sw = [jnp.swapaxes(x, 1, 2) for x in (q, k, v)]
        g = jnp.asarray(IN[key + "__g"], getattr(jnp, dt))
        for causal in (True, False):
            o, vjp = jax.vjp(lambda a, b, c: attention(
                a, b, c, causal=causal, use_kernel=True), *sw)
            tag = f"{key}__{dt}__{int(causal)}__grad"
            OUT[tag + "__o"] = np.asarray(o, np.float32)
            for name, gr in zip("qkv", vjp(g)):
                OUT[f"{tag}__d{name}"] = np.asarray(gr, np.float32)
for key in IN["sk_keys"]:
    key = str(key)
    qj, kj, vj = (jnp.asarray(IN[key + n], jnp.bfloat16)
                  for n in ("__q", "__k", "__v"))
    for causal in (True, False):
        OUT[f"{key}__{int(causal)}__ref"] = np.asarray(
            attention_ref(qj, kj, vj, causal=causal), np.float32)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {"keys": np.array([_key(s) for s in SHAPES + [RAGGED]]),
              "sk_keys": np.array([_key(s) for s in SK_CASES]),
              "grad_keys": np.array([_key(s) for s in GRAD_SHAPES])}
    for shape in GRAD_SHAPES:
        inputs[f"{_key(shape)}__g"] = _cotangent(shape)
    for shape in SHAPES + [RAGGED]:
        q, k, v = _inputs(*shape)
        inputs.update({f"{_key(shape)}__q": q, f"{_key(shape)}__k": k,
                       f"{_key(shape)}__v": v})
    for shape in SK_CASES:
        q, k, v = _sk_inputs(*shape)
        inputs.update({f"{_key(shape)}__q": q, f"{_key(shape)}__k": k,
                       f"{_key(shape)}__v": v})
    return run_reference(REFERENCE, inputs, tmp_path_factory.mktemp("flash"))


def _torch_inputs(shape, dtype, device="cpu"):
    return tuple(torch.from_numpy(x).to(device=device,
                                        dtype=getattr(torch, dtype))
                 for x in _inputs(*shape))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_plain_matches_jax_kernel_and_reference(ref, shape, causal, dtype):
    q, k, v = _torch_inputs(shape, dtype)
    tag = f"{_key(shape)}__{dtype}__{int(causal)}"
    got = attention_plain(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, ref[tag + "__flash"], dtype)
    _close(got, ref[tag + "__ref"], dtype)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(flash_attention(q, k, v, causal=causal), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_sequence_matches_reference(ref, causal, dtype):
    q, k, v = _torch_inputs(RAGGED, dtype)
    got = flash_attention(q, k, v, causal=causal)
    _close(got, ref[f"{_key(RAGGED)}__{dtype}__{int(causal)}__ref"], dtype)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES[1:], ids=_key)
def test_model_layout_matches_jax(ref, shape, causal, dtype, use_kernel):
    q, k, v = (x.transpose(1, 2) for x in _torch_inputs(shape, dtype))
    got = attention(q, k, v, causal=causal, use_kernel=use_kernel)
    assert got.shape == q.shape
    tag = f"{_key(shape)}__{dtype}__{int(causal)}"
    _close(got, ref[tag + "__ops"], dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SK_CASES, ids=_key)
def test_bf16_head_dims_and_sk_match_reference(ref, shape, causal):
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _sk_inputs(*shape))
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, ref[f"{_key(shape)}__{int(causal)}__ref"], "bfloat16")


def _fused_views(q, k, v):
    """q, k, v [B, H(kv), S, D] copied into one [B, S, H + 2 Hkv, D] tensor
    and returned as its three non-contiguous [B, S, heads, D] views, as a
    fused QKV projection would give them."""
    h, hkv = q.shape[1], k.shape[1]
    fused = torch.cat([x.transpose(1, 2) for x in (q, k, v)], dim=2)
    views = (fused[:, :, :h], fused[:, :, h:h + hkv], fused[:, :, h + hkv:])
    assert not any(x.is_contiguous() for x in views)
    return views


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES[1:], ids=_key)
def test_model_layout_takes_non_contiguous_views(ref, shape, causal, dtype):
    views = _fused_views(*_torch_inputs(shape, dtype))
    got = attention(*views, causal=causal, use_kernel=True)
    assert got.shape == views[0].shape
    _close(got, ref[f"{_key(shape)}__{dtype}__{int(causal)}__ops"], dtype)


@pytest.mark.parametrize("bad, match", [
    (lambda q, k, v: (q.half(), k.half(), v.half()), "float32 or bfloat16"),
    (lambda q, k, v: (q, k.double(), v), "one dtype"),
    (lambda q, k, v: (q[:, :3], k, v), "multiple of Hkv"),
    (lambda q, k, v: (q, k[..., :32], v[..., :32]), "do not match"),
    (lambda q, k, v: (q, k, v[:, :, :10]), "do not match"),
    (lambda q, k, v: (q[0], k[0], v[0]), r"\[B, H, S, D\]"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    q, k, v = _torch_inputs((1, 4, 2, 16, 64), "float32")
    with pytest.raises(ValueError, match=match):
        flash_attention(*bad(q, k, v))


def _model_layout_grads(shape, dtype, causal, use_kernel, device="cpu"):
    """(o, dq, dk, dv) of ``ops.attention`` on the model layout, for the
    seeded cotangent, as float32 numpy."""
    q, k, v = (x.transpose(1, 2).requires_grad_()
               for x in _torch_inputs(shape, dtype, device))
    o = attention(q, k, v, causal=causal, use_kernel=use_kernel)
    g = torch.from_numpy(_cotangent(shape)).to(device=device, dtype=o.dtype)
    o.backward(g)
    return tuple(x.detach().float().cpu().numpy()
                 for x in (o, q.grad, k.grad, v.grad))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=_key)
def test_kernel_path_gradients_match_jax_custom_vjp(ref, shape, causal,
                                                    dtype):
    # the autograd Function's backward recomputes through the plain
    # version, as JAX's custom_vjp recomputes through attention_ref
    got = _model_layout_grads(shape, dtype, causal, use_kernel=True)
    tag = f"{_key(shape)}__{dtype}__{int(causal)}__grad"
    for name, a in zip(("o", "dq", "dk", "dv"), got):
        want = ref[f"{tag}__{name}"]
        tol = TOL[dtype] * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(a, want, rtol=TOL[dtype], atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_path_gradients_equal_the_plain_path_on_the_cpu(causal):
    # on CPU tensors the kernel path's forward is the plain version, so
    # the two paths' gradients are the same numbers
    got = _model_layout_grads(SHAPES[3], "float32", causal, use_kernel=True)
    want = _model_layout_grads(SHAPES[3], "float32", causal,
                               use_kernel=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_kernel_path_without_a_gradient_keeps_no_graph():
    q, k, v = (x.transpose(1, 2).requires_grad_()
               for x in _torch_inputs((1, 4, 2, 16, 64), "float32"))
    with torch.no_grad():
        o = attention(q, k, v, use_kernel=True)
    assert o.grad_fn is None and not o.requires_grad
    o = attention(q, k, v, use_kernel=True)
    assert o.requires_grad
    o.sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None


def test_cpu_tensors_do_not_count_as_launches():
    reset_launch_counts()
    flash_attention(*_torch_inputs((1, 4, 2, 16, 64), "float32"))
    assert launch_counts()["flash_attention"] == 0


# ------------------------------- on the card -------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ for sm_90a "
                    "and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [RAGGED, (2, 4, 1, 1000, 32),
                                           (1, 2, 2, 65, 128),
                                           (2, 4, 2, 77, 16)], ids=_key)
def test_kernel_matches_plain_on_the_card(cuda, shape, causal, dtype):
    q, k, v = _torch_inputs(shape, dtype, cuda)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    want = attention_plain(q, k, v, causal=causal)
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, want.float().cpu().numpy(), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sk_of", ["same", "longer", "shorter"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 1000, 2048])
def test_bf16_kernel_sequence_lengths_on_the_card(cuda, s, sk_of, d, causal):
    sk = {"same": s, "longer": s + 37, "shorter": max(1, s // 2 + 5)}[sk_of]
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _sk_inputs(2, 4, 2, s, sk, d))
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    want = attention_plain(q, k, v, causal=causal)
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, want.float().cpu().numpy(), "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 14, 2, 300, 64), (1, 16, 16, 257, 128),
                                   (2, 4, 1, 100, 32)], ids=_key)
def test_kernels_take_strided_views_on_the_card(cuda, shape, dtype):
    """Views of a fused projection, and rows cut from wider ones, go to the
    kernels as they are; the model-layout entry allocates only its output
    and returns it as a contiguous [B, S, H, D]."""
    q, k, v = _torch_inputs(shape, dtype, cuda)
    want = attention_plain(q, k, v)
    views = _fused_views(q, k, v)
    kern = tuple(x.transpose(1, 2) for x in views)
    got = flash_attention(*kern)
    assert got.transpose(1, 2).is_contiguous()  # [B, S, H, D], as q's views
    _close(got, want.float().cpu().numpy(), dtype)
    # rows that are slices of wider rows (row stride D + 8)
    wide = tuple(torch.cat([x, torch.zeros_like(x[..., :8])], dim=-1)
                 for x in (q, k, v))
    _close(flash_attention(*(x[..., :shape[-1]] for x in wide)),
            want.float().cpu().numpy(), dtype)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = attention(*views, use_kernel=True)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before + 1
    assert out.is_contiguous()
    _close(out.transpose(1, 2), want.float().cpu().numpy(), dtype)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _torch_inputs((1, 4, 2, 128, 64), "float32", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    q48, k48, v48 = (x[..., :48].contiguous() for x in (q, k, v))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q48, k48, v48)
    # the bf16 kernel's TMA loads need strides that are multiples of 8
    wide = torch.zeros((1, 4, 128, 68), dtype=torch.bfloat16, device=cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(wide[..., :64], k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=_key)
def test_kernel_path_gradients_on_the_card(cuda, shape, causal, dtype):
    # K5 forward under autograd: one launch, and the gradients of the
    # plain recomputation within the kernel's tolerance of the plain path's
    reset_launch_counts()
    got = _model_layout_grads(shape, dtype, causal, True, cuda)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    want = _model_layout_grads(shape, dtype, causal, False, cuda)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        tol = TOL[dtype] * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=TOL[dtype], atol=tol,
                                   err_msg=name)
