"""The port's window attention (K7's plain twins, the CPU path of
``skinjax_torch.ops.window_attention``) against skinjax's
``window_attention_nhwc``, run as its own tests run it on the CPU (the Pallas
kernels in interpret mode): the same numpy inputs on both sides, forward and
every gradient, with and without bias and mask, both kernel interfaces;
fp32 and bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skinjax.ops.pallas import window_attention as jwa
from skinjax_torch.ops import window_attention as twa
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

WINDOW = 7


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B=2, H=14, W=14, C=96, h=3, bias=False, mask=False, seed=3):
    rng = np.random.default_rng(seed)
    N = WINDOW * WINDOW
    f = np.float32
    arrays = [rng.normal(size=(B, H, W, C)).astype(f) * 0.5,
              (rng.normal(size=(C, 3 * C)) * 0.05).astype(f),
              (rng.normal(size=(3 * C,)) * 0.02).astype(f),
              (rng.normal(size=(C, C)) * 0.05).astype(f),
              (rng.normal(size=(C,)) * 0.02).astype(f)]
    b = (rng.normal(size=(h, N, N)) * 0.1).astype(f) if bias else None
    n_win = (H // WINDOW) * (W // WINDOW)
    m = None
    if mask:  # Swin-style: -100 on a fifth of the pairs, never on the diagonal
        m = np.where(rng.uniform(size=(n_win, N, N)) > 0.8, -100.0, 0.0).astype(f)
        m[:, np.arange(N), np.arange(N)] = 0.0
    return arrays, b, m


def _jax(a, dtype):
    return None if a is None else jnp.asarray(a, dtype)


def _torch(a, dtype, grad=False):
    if a is None:
        return None
    return torch.tensor(a, dtype=dtype, requires_grad=grad)


def _f32(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else \
        t.detach().float().numpy()


def _bf16_ulp(x):
    """One bf16 ulp at the magnitude of max |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


CASES = {  # name: (B, H, W, C, heads, bias, mask)
    "2x2 windows": (2, 14, 14, 96, 3, False, False),
    "one window": (2, 7, 7, 96, 3, False, False),
    "4x4 windows, 2 heads": (1, 28, 28, 64, 2, False, False),
    "bias": (2, 14, 14, 96, 3, True, False),
    "bias and mask": (2, 14, 14, 96, 3, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_skinjax_fp32(case):
    B, H, W, C, h, bias, mask = CASES[case]
    arrays, b, m = _inputs(B, H, W, C, h, bias, mask)
    ref = jwa.window_attention_nhwc(*(_jax(a, jnp.float32) for a in arrays), _jax(b, jnp.float32),
                                    _jax(m, jnp.float32), h, WINDOW)
    twa.reset_launches()
    out = twa.window_attention_nhwc(*(_torch(a, torch.float32) for a in arrays),
                                    _torch(b, torch.float32), _torch(m, torch.float32), h, WINDOW)
    assert sum(twa.LAUNCHES.values()) == 0  # CPU tensors take the twins
    assert out.shape == (B, H, W, C) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _grads_jax(arrays, b, m, h, iface):
    def loss(x, wqkv, bqkv, wproj, bproj, bias):
        y = jwa.window_attention_nhwc(x, wqkv, bqkv, wproj, bproj, bias, _jax(m, jnp.float32), h,
                                      WINDOW, iface)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))

    args = [_jax(a, jnp.float32) for a in arrays] + [_jax(b, jnp.float32)]
    argnums = tuple(range(6 if b is not None else 5))
    return jax.grad(loss, argnums=argnums)(*args)


def _grads_torch(arrays, b, m, h):
    args = [_torch(a, torch.float32, grad=True) for a in arrays]
    bias = _torch(b, torch.float32, grad=True)
    y = twa.window_attention_nhwc(*args, bias, _torch(m, torch.float32), h, WINDOW)
    torch.sin(y.float()).sum().backward()
    return [a.grad for a in args] + ([bias.grad] if bias is not None else [])


@pytest.mark.parametrize("iface", ["6d", "4d"])
@pytest.mark.parametrize("case", ["2x2 windows", "bias and mask"])
def test_gradients_match_skinjax_fp32(case, iface):
    """dx, dwqkv, dbqkv, dwproj, dbproj (and dbias) against jax.grad through
    skinjax's custom VJP, on both of its kernel interfaces."""
    B, H, W, C, h, bias, mask = CASES[case]
    arrays, b, m = _inputs(B, H, W, C, h, bias, mask, seed=4)
    ref = _grads_jax(arrays, b, m, h, iface)
    out = _grads_torch(arrays, b, m, h)
    names = ["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]
    assert len(out) == len(ref)
    for name, o, r in zip(names, out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4, err_msg=name)


def test_forward_4d_interface_matches_the_twin():
    """skinjax's 4-D NHWC-strip interface (``iface="4d"``) computes the same
    function as the 6-D one; one CUDA kernel pair serves both."""
    arrays, b, m = _inputs(2, 14, 14, 96, 3, True, True, seed=5)
    ref = jwa.window_attention_nhwc(*(_jax(a, jnp.float32) for a in arrays), _jax(b, jnp.float32),
                                    _jax(m, jnp.float32), 3, WINDOW, "4d")
    out = twa.window_attention_nhwc_plain(*(_torch(a, torch.float32) for a in arrays),
                                          _torch(b, torch.float32), _torch(m, torch.float32), 3,
                                          WINDOW)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["2x2 windows", "bias and mask"])
def test_backward_twin_matches_strip_bwd(case, dtype):
    """The backward twin returns what skinjax's ``_strip_bwd`` returns:
    (dqkv, of, dbias) in NHWC. fp32 within 1e-5; bf16 within 2 bf16 ulps
    of each output's scale (the two round at the same points, and a sum that
    lands near a rounding point may round the other way)."""
    B, H, W, C, h, bias, mask = CASES[case]
    arrays, b, m = _inputs(B, H, W, C, h, bias, mask, seed=6)
    dy = np.random.default_rng(7).normal(size=(B, H, W, C)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    x, wqkv, bqkv, wproj, _ = arrays
    ref = jwa._strip_bwd(_jax(x, jdt), _jax(dy, jdt), _jax(wqkv, jdt), _jax(bqkv, jdt),
                         _jax(wproj, jdt), _jax(b, jnp.float32), _jax(m, jnp.float32),
                         num_heads=h, window=WINDOW)
    out = twa.window_attention_nhwc_bwd_plain(
        _torch(x, tdt), _torch(dy, tdt), _torch(wqkv, tdt), _torch(bqkv, tdt), _torch(wproj, tdt),
        _torch(b, torch.float32), _torch(m, torch.float32), h, WINDOW)
    assert (out[2] is None) == (b is None)
    for name, o, r in zip(("dqkv", "of", "dbias"), out, ref):
        if r is None:
            continue
        r = _f32(r)
        assert o.shape == r.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(_f32(o), r, atol=1e-5, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(_f32(o), r, atol=2 * _bf16_ulp(r), rtol=0, err_msg=name)


@pytest.mark.parametrize("case", ["2x2 windows", "bias and mask"])
def test_forward_matches_skinjax_bf16(case):
    B, H, W, C, h, bias, mask = CASES[case]
    arrays, b, m = _inputs(B, H, W, C, h, bias, mask, seed=8)
    ref = _f32(jwa.window_attention_nhwc(*(_jax(a, jnp.bfloat16) for a in arrays),
                                         _jax(b, jnp.float32), _jax(m, jnp.float32), h, WINDOW))
    out = twa.window_attention_nhwc(*(_torch(a, torch.bfloat16) for a in arrays),
                                    _torch(b, torch.float32), _torch(m, torch.float32), h, WINDOW)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), ref, atol=2 * _bf16_ulp(ref), rtol=0)


@pytest.mark.parametrize("case", ["2x2 windows", "bias and mask"])
def test_twin_matches_the_reference_fp32(case):
    """The twin against skinjax's einsum reference on partitioned windows,
    and the port's copies of the reference and of window_partition/reverse
    against skinjax's."""
    from skinjax.models.backbones.transformer_zoo import window_partition, window_reverse

    B, H, W, C, h, bias, mask = CASES[case]
    arrays, b, m = _inputs(B, H, W, C, h, bias, mask, seed=9)
    x, wqkv, bqkv, wproj, bproj = arrays
    jx = window_partition(jnp.asarray(x), WINDOW)
    np.testing.assert_array_equal(twa.window_partition(torch.tensor(x), WINDOW).numpy(),
                                  np.asarray(jx))
    ref_w = jwa.window_attention_reference(jx, wqkv, bqkv, wproj, bproj, h, _jax(b, jnp.float32),
                                           _jax(m, jnp.float32))
    ref = np.asarray(window_reverse(ref_w, WINDOW, H, W))
    out_w = twa.window_attention_reference(twa.window_partition(torch.tensor(x), WINDOW),
                                           *(torch.tensor(a) for a in arrays[1:]), h,
                                           _torch(b, torch.float32), _torch(m, torch.float32))
    np.testing.assert_allclose(out_w.numpy(), np.asarray(ref_w), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(twa.window_reverse(torch.tensor(np.asarray(ref_w)), WINDOW, H,
                                                     W).numpy(), ref)
    out = twa.window_attention_nhwc_plain(*(torch.tensor(a) for a in arrays),
                                          _torch(b, torch.float32), _torch(m, torch.float32), h,
                                          WINDOW)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["2x2 windows", "bias and mask"])
def test_forward_returns_the_backwards_of(case, dtype):
    """``return_of`` hands back the forward's of beside y: on the CPU the
    twin's, the backward twin's of bit for bit (on the card one core function
    computes both, and chip_smoke.py holds them bit for bit); the padded entry
    on the same windows gives the partitioned of and y."""
    B, H, W, C, h, bias, mask = CASES[case]
    arrays, b, m = _inputs(B, H, W, C, h, bias, mask)
    x, wqkv, bqkv, wproj, bproj = (torch.tensor(a).to(dtype) for a in arrays)
    bt, mt = _torch(b, torch.float32), _torch(m, torch.float32)
    y, of = twa.window_attention_fwd(x, wqkv, bqkv, wproj, bproj, bt, mt, h, WINDOW,
                                     return_of=True)
    assert of.shape == x.shape and of.dtype == dtype
    assert torch.equal(y, twa.window_attention_fwd(x, wqkv, bqkv, wproj, bproj, bt, mt, h, WINDOW))
    _, of_bwd, _ = twa.window_attention_bwd(x, torch.zeros_like(x), wqkv, bqkv, wproj, bt, mt, h,
                                            WINDOW)
    assert torch.equal(of, of_bwd)
    yp, ofp = twa.window_attention_pad_fwd(twa.window_partition(x, WINDOW), wqkv, bqkv, wproj,
                                           bproj, bt, mt, h, return_of=True)
    assert torch.equal(ofp, twa.window_partition(of, WINDOW))
    assert torch.equal(yp, twa.window_partition(y, WINDOW))


def test_backward_blocks():
    """The backward kernel's window blocks, each launched once a head: one a
    window; with a bias gradient at most BIAS_BLOCKS, each summing its
    windows' dbias into its own (heads, N, N) fp32 partial plane."""
    assert twa.bwd_blocks(4096, False) == 4096
    assert twa.bwd_blocks(4096, True) == twa.BIAS_BLOCKS == 256
    assert twa.bwd_blocks(64, True) == 64
    assert twa.bwd_blocks(1, False) == twa.bwd_blocks(1, True) == 1


def test_bad_shapes_raise():
    arrays, _, _ = _inputs(1, 14, 12, 96, 3)
    with pytest.raises(ValueError, match="multiples of the window"):
        twa.window_attention_nhwc(*(torch.tensor(a) for a in arrays), None, None, 3, WINDOW)
    x = torch.zeros(1, 7, 7, 96)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        twa.window_attention_fwd(x.to("meta"), *(torch.zeros(s, device="meta") for s in
                                     ((96, 288), (288,), (96, 96), (96,))), None, None, 3, WINDOW)


# K7's padded entry on partitioned windows: name -> (windows, C, heads, bias,
# mask planes); window j adds mask[j % planes]. The second is skinjax's
# test_mask_period_exceeds_block case (64 shifted masks, more than its
# kernel's window block).
PAD_CASES = {"bias, 4 masks": (8, 64, 2, True, 4),
             "mask period exceeds block": (128, 96, 3, False, 64)}


def _pad_inputs(case, seed):
    nB, C, h, bias, n_mask = PAD_CASES[case]
    rng = np.random.default_rng(seed)
    N = WINDOW * WINDOW
    f = np.float32
    arrays = [rng.normal(size=(nB, N, C)).astype(f) * 0.5,
              (rng.normal(size=(C, 3 * C)) * 0.05).astype(f),
              (rng.normal(size=(3 * C,)) * 0.02).astype(f),
              (rng.normal(size=(C, C)) * 0.05).astype(f),
              (rng.normal(size=(C,)) * 0.02).astype(f)]
    b = (rng.normal(size=(h, N, N)) * 0.1).astype(f) if bias else None
    m = np.where(rng.uniform(size=(n_mask, N, N)) > 0.8, -100.0, 0.0).astype(f)
    m[:, np.arange(N), np.arange(N)] = 0.0
    return arrays, b, m, h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PAD_CASES))
def test_padded_forward_matches_skinjax(case, dtype):
    """The padded entry's forward twin against skinjax's ``window_attention``
    (its ``_fwd`` Pallas kernel, interpret mode) with the bias and
    period-``nW`` masks: fp32 within 1e-5, bf16 within 2 ulps."""
    arrays, b, m, h = _pad_inputs(case, seed=10)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    ref = _f32(jwa.window_attention(*(_jax(a, jdt) for a in arrays), _jax(b, jnp.float32),
                                    _jax(m, jnp.float32), h))
    twa.reset_launches()
    out = twa.window_attention(*(_torch(a, tdt) for a in arrays), _torch(b, torch.float32),
                               _torch(m, torch.float32), h)
    assert sum(twa.LAUNCHES.values()) == 0
    assert out.dtype == tdt and out.shape == arrays[0].shape
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), ref, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(_f32(out), ref, atol=2 * _bf16_ulp(ref), rtol=0)


@pytest.mark.parametrize("case", list(PAD_CASES))
def test_padded_gradients_match_skinjax(case):
    """dx, dwqkv, dbqkv, dwproj, dbproj (and dbias) through the padded
    entry's autograd.Function (``_bwd_call``'s matrix products around the
    recompute core's twin with the window mask) against jax.grad through
    skinjax's custom VJP (its ``_bwd_core`` Pallas kernel), jitted, fp32 at
    1e-4."""
    arrays, b, m, h = _pad_inputs(case, seed=11)
    dy = np.random.default_rng(12).normal(size=arrays[0].shape).astype(np.float32)
    mask = jnp.asarray(m)

    def loss(*a):
        bias = a[5] if b is not None else None
        return jnp.sum(jwa.window_attention(*a[:5], bias, mask, h) * jnp.asarray(dy))

    jargs = [jnp.asarray(a) for a in arrays] + ([jnp.asarray(b)] if b is not None else [])
    ref = jax.jit(jax.grad(loss, argnums=tuple(range(len(jargs)))))(*jargs)
    targs = [_torch(a, torch.float32, grad=True) for a in arrays]
    bias = _torch(b, torch.float32, grad=True)
    twa.window_attention(*targs, bias, _torch(m, torch.float32), h).backward(torch.tensor(dy))
    out = [t.grad for t in targs] + ([bias.grad] if bias is not None else [])
    assert len(out) == len(ref)
    for name, o, r in zip(["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"], out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4, err_msg=name)
