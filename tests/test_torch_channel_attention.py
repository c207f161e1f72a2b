"""The port's channel attention (K8's plain twins, the CPU path of
``skinjax_torch.ops.channel_attention``) against skinjax's
``ops/pallas/channel_attention.py``, run as its own tests run it on the CPU
(the Pallas kernels in interpret mode): the same numpy inputs on both sides;
the forward and the backward kernel's outputs, fp32 and bf16; all five
gradients through the autograd.Function against ``jax.vjp`` of skinjax's
custom VJP; the twins against skinjax's einsum reference; the backward
against autograd of the twin in float64. Then a small DaViT with
``ch_fused_attn=True`` against skinjax's, weights carried across by
``state_dict_from_flax``, forward and every gradient in fp32, and the
``SKINJAX_CHATTN`` knob."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skinjax.models.backbones import davit as jax_davit
from skinjax.ops.pallas import channel_attention as jca
from skinjax_torch.models.backbones import davit
from skinjax_torch.models.weights import state_dict_from_flax
from skinjax_torch.ops import channel_attention as tca
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name: (B, N, C, heads); 32 channels a head as DaViT-tiny's, and 16
CASES = {"ragged N, 2 heads": (2, 37, 64, 2), "3 heads of 16": (1, 50, 48, 3)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(case, seed):
    B, N, C, h = CASES[case]
    rng = np.random.default_rng(seed)
    f = np.float32
    arrays = [rng.normal(size=(B, N, C)).astype(f),
              (rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(f),
              (rng.normal(size=(3 * C,)) * 0.1).astype(f),
              (rng.normal(size=(C, C)) * C ** -0.5).astype(f),
              (rng.normal(size=(C,)) * 0.1).astype(f)]
    dy = rng.normal(size=(B, N, C)).astype(f)
    return arrays, dy, h


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(out, ref, dtype, name):
    """fp32 within 1e-5; bf16 within 2 bf16 ulps of the output's scale (the
    two round at the same points, and a sum that lands near a rounding point
    may round the other way)."""
    r = _f32(ref)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), r, atol=1e-5, rtol=1e-5, err_msg=name)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
        np.testing.assert_allclose(_f32(out), r, atol=2 * ulp, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_skinjax(case, dtype):
    """y against skinjax's ``channel_attention`` (its Pallas kernel)."""
    arrays, _, h = _inputs(case, seed=1)
    jdt, tdt = DTYPES[dtype]
    ref = jca.channel_attention(*(jnp.asarray(a, jdt) for a in arrays), h)
    tca.reset_launches()
    out = tca.channel_attention_fwd(*(torch.tensor(a).to(tdt) for a in arrays), h)
    assert sum(tca.LAUNCHES.values()) == 0  # CPU tensors take the twins
    assert out.dtype == tdt and out.shape == arrays[0].shape
    _close(out, ref, dtype, "y")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_backward_twin_matches_ch_bwd_kernel(case, dtype):
    """(dqkv, of) against what skinjax's ``_ch_bwd_kernel`` returns, (dq,
    dk, dv, of), from x and dy."""
    arrays, dy, h = _inputs(case, seed=2)
    jdt, tdt = DTYPES[dtype]
    x, wqkv, bqkv, wproj, _ = (jnp.asarray(a, jdt) for a in arrays)
    dq, dk, dv, of = jca._ch_call(x, wqkv, bqkv, wproj, None, num_heads=h, bwd=True,
                                  dy=jnp.asarray(dy, jdt))
    t = [torch.tensor(a).to(tdt) for a in arrays]
    dqkv, tof = tca.channel_attention_bwd(t[0], torch.tensor(dy).to(tdt), t[1], t[2], t[3], h)
    assert dqkv.dtype == tof.dtype == tdt
    C = arrays[0].shape[-1]
    for name, o, r in (("dq", dqkv[..., :C], dq), ("dk", dqkv[..., C:2 * C], dk),
                       ("dv", dqkv[..., 2 * C:], dv), ("of", tof, of)):
        _close(o, r, dtype, name)


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    """y and the five gradients of sum(y·dy) through skinjax's custom VJP,
    fp32, jitted once a case."""
    arrays, dy, h = _inputs(case, seed=3)

    def loss(*a):
        return jnp.sum(jca.channel_attention(*a, h) * jnp.asarray(dy))

    return jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_vjp(case):
    """dx, dwqkv, dbqkv, dwproj, dbproj through the autograd.Function against
    skinjax's ``_ca_bwd`` (jax.grad of its custom VJP), fp32 within 1e-5."""
    arrays, dy, h = _inputs(case, seed=3)
    args = [torch.tensor(a, requires_grad=True) for a in arrays]
    tca.channel_attention(*args, h).backward(torch.tensor(dy))
    for name, a, r in zip(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj"), args, _jax_grads(case)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_and_reference_copy_match_skinjax_reference(case):
    """The port's copy of the einsum reference against skinjax's, and the
    twin against it: fp32 within 1e-5 (the reference scales k before the
    product, the twin the fp32 scores after it)."""
    arrays, _, h = _inputs(case, seed=4)
    ref = np.asarray(jca.channel_attention_reference(*(jnp.asarray(a) for a in arrays), h))
    t = [torch.tensor(a) for a in arrays]
    np.testing.assert_allclose(tca.channel_attention_reference(*t, h).numpy(), ref, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tca.channel_attention_plain(*t, h).numpy(), ref, atol=1e-5,
                               rtol=1e-5)


def test_autograd_function_matches_autograd_of_the_twin_float64():
    """The backward's algebra: every gradient of the autograd.Function
    against autograd through the forward twin, in float64."""
    arrays, dy, h = _inputs("ragged N, 2 heads", seed=5)

    def grads(fn):
        args = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in arrays]
        fn(*args, h).backward(torch.tensor(dy, dtype=torch.float64))
        return [a.grad for a in args]

    for g, r in zip(grads(tca.channel_attention), grads(tca.channel_attention_plain)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-12, rtol=1e-10)


def test_bad_inputs_raise():
    x = torch.zeros(1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tca.channel_attention_fwd(x, *(torch.zeros(s, device="meta") for s in
                                       ((64, 192), (192,), (64, 64), (64,))), 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tca.channel_attention_bwd(x, x, *(torch.zeros(s, device="meta") for s in
                                          ((64, 192), (192,), (64, 64))), 2)


# a small DaViT: 56×56 images, stage 0 a 14×14 map (4 windows), stage 1 7×7;
# 32 channels a head as davit_tiny
DAVIT_KW = dict(dims=(32, 64), depths=(1, 1), heads=(1, 2), window=7)
HW = 56


@functools.lru_cache(maxsize=None)
def _jax_davit():
    """skinjax's small DaViT with ch_fused_attn=True (its K8 Pallas kernel on
    every channel block, in interpret mode), random fp32 parameters drawn
    with numpy on its eval_shape tree, an input and a cotangent; y and the
    parameter gradients of sum(y·dy), jitted once."""
    module = jax_davit.DaViT(**DAVIT_KW, ch_fused_attn=True)
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, HW, HW, 3)))["params"]
    rng = np.random.default_rng(6)

    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
    x = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    dy = rng.normal(size=(2, DAVIT_KW["dims"][-1])).astype(np.float32)

    def loss(p):
        y = module.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(y * dy), y

    (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return params, x, dy, np.asarray(y), grads


def _to_port(tree):
    """A skinjax DaViT tree as the port tower's state_dict (the converter)."""
    sd = state_dict_from_flax({"image_encoder": tree}, {})
    return {k[len("image_encoder."):]: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def test_small_davit_with_k8_matches_skinjax():
    """The port's DaViT with ``ch_fused_attn=True`` (K8's twin on every
    channel block) against skinjax's with its K8 kernel, the weights carried
    across by ``state_dict_from_flax``: y and every parameter gradient (the
    gradient tree converted the same way), fp32 within 1e-4."""
    params, x, dy, y_ref, g_ref = _jax_davit()
    port = davit.DaViT(*DAVIT_KW.values(), ch_fused_attn=True)
    port.load_state_dict(_to_port(params))
    calls = []
    fwd = tca.channel_attention_fwd
    tca.channel_attention_fwd = lambda *a: calls.append(1) or fwd(*a)
    try:
        y = port(torch.tensor(x))
    finally:
        tca.channel_attention_fwd = fwd
    assert len(calls) == sum(DAVIT_KW["depths"])
    np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=1e-4, rtol=1e-4)
    y.backward(torch.tensor(dy))
    want = _to_port(g_ref)
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    for k, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("env,attribute,fused", [("", None, False), ("pallas", None, True),
                                                 ("pallas", False, False), ("", True, True)])
def test_channel_attention_route(monkeypatch, env, attribute, fused):
    """skinjax's attribute decides; where it is None, ``SKINJAX_CHATTN=pallas``
    (read at each forward) sends the channel attention through K8. Both
    routes compute the same function (fp32 within 1e-5)."""
    monkeypatch.setenv("SKINJAX_CHATTN", env)
    block = davit.DaViTChannelAttention(64, 2, attribute)
    calls = []
    monkeypatch.setattr(tca, "channel_attention_fwd",
                        lambda *a, f=tca.channel_attention_fwd: calls.append(1) or f(*a))
    x = torch.tensor(np.random.default_rng(7).normal(size=(2, 37, 64)).astype(np.float32))
    y = block(x)
    assert len(calls) == int(fused)
    monkeypatch.setenv("SKINJAX_CHATTN", "" if fused else "pallas")
    block.fused = None if attribute is None else not attribute
    np.testing.assert_allclose(y.detach().numpy(), block(x).detach().numpy(), atol=1e-5,
                               rtol=1e-5)


# DaViT-tiny's channel attention at 224×224: (tokens, channels, heads) per
# stage, 32 channels a head; its train batch
DAVIT_TINY_STAGES = ((3136, 96, 3), (784, 192, 6), (196, 384, 12), (49, 768, 24))
DAVIT_B = 64


@pytest.mark.parametrize("backward", [False, True])
def test_launch_plan(backward):
    """What the wrapper allocates and launches on the card: bf16 at 32
    channels a head and a multiple of three heads takes the tensor-core
    kernels (``HEAD_GROUP`` = 3 heads a block) at each of DaViT-tiny's
    stages, with no scratch in the input dtype in the forward and, in the
    backward, q, k, v and do as four (B, N, C) planes, not interleaved by
    token; fp32, bf16 at 16 channels a head and bf16 at four heads
    (DaViT-base's layout) keep the CUDA-core kernels and their scratch (the
    forward's of, the backward's interleaved q, k, v, do)."""
    assert tca.HEAD_GROUP == 3
    for N, C, h in DAVIT_TINY_STAGES:
        n_seg = -(-N // tca.SEGMENT)
        planes = (2 * n_seg + 2 if backward else n_seg + 1, DAVIT_B, h, 32, 32)
        got = tca.plan(torch.bfloat16, DAVIT_B, N, C, h, backward)
        scratch = (4, DAVIT_B, N, C) if backward else None
        assert got == dict(route="mma", n_seg=n_seg, planes=planes, scratch=scratch)
        got = tca.plan(torch.float32, DAVIT_B, N, C, h, backward)
        scratch = (DAVIT_B, N, 4, C) if backward else (DAVIT_B, N, C)
        assert got == dict(route="cuda-core", n_seg=n_seg, planes=planes, scratch=scratch)
    assert [tca.plan(torch.bfloat16, DAVIT_B, N, C, h, backward)["n_seg"]
            for N, C, h in DAVIT_TINY_STAGES] == [13, 4, 1, 1]
    assert tca.plan(torch.bfloat16, 1, 50, 48, 3, backward)["route"] == "cuda-core"
    got = tca.plan(torch.bfloat16, 8, 784, 128, 4, backward)
    assert got["route"] == "cuda-core"
    assert got["scratch"] == ((8, 784, 4, 128) if backward else (8, 784, 128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_t_is_one_contiguous_copy(dtype):
    """``weight_t``: a Linear's (out, in) weight as a contiguous (in, out)
    tensor in either dtype, a copy (not a view of the weight), through which
    the gradient reaches the weight."""
    from skinjax_torch.ops import weight_t

    w = torch.tensor(np.random.default_rng(3).normal(size=(6, 4)).astype(np.float32),
                     requires_grad=True)
    wt = weight_t(w, dtype)
    assert wt.shape == (4, 6) and wt.dtype == dtype and wt.is_contiguous()
    assert wt.stride() == (6, 1) and wt.data_ptr() != w.data_ptr()
    torch.testing.assert_close(wt, w.detach().t().to(dtype), rtol=0, atol=0)
    g = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    (wt.float() * g).sum().backward()
    torch.testing.assert_close(w.grad, g.t())
