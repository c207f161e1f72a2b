"""The port's augmentation against skinjax's: the color-stage kernel's plain
twin (K5) against skinjax's Pallas kernel (interpret mode) and its jnp chain,
the geometry against skinjax's with the same angles, scales and sigmas, eval
normalize exactly, and the random gates in distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skinjax.data import augment as J
from skinjax.ops.pallas.augment_kernel import draw_color_params as jax_draw_color_params
from skinjax.ops.pallas.augment_kernel import fused_color_stage as jax_fused_color_stage
from skinjax_torch.data import augment as A
from skinjax_torch.ops import augment_kernel as ak
from tests.test_augment_distribution import _structured_batch
from tests.test_augment_kernel import _ref_chain
from tests.xla_compile_cache import xla_compile_cache, xla_optimized  # noqa: F401

GATES_ON = dict(J.DEFAULT_CFG, p_dropout=1.0, p_hsv=1.0, p_bc=1.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes,
    and PyTorch's default of a thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(B, H, W, cfg, seed):
    fp, ip = jax_draw_color_params(jax.random.key(seed), B, H, W, cfg)
    return np.asarray(fp), np.asarray(ip)


def _twin(img, fp, ip, out_dtype=torch.float32):
    return ak.fused_color_stage(torch.from_numpy(img), torch.from_numpy(fp.copy()),
                                torch.from_numpy(ip.copy()), out_dtype=out_dtype)


@pytest.mark.parametrize("cfg", ["drawn", "every gate on"])
def test_k5_twin_matches_the_pallas_kernel(cfg):
    B, H, W = 2, 16, 24
    img = np.random.default_rng(0).uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    fp, ip = _params(B, H, W, GATES_ON if cfg != "drawn" else J.DEFAULT_CFG, seed=1)
    ref = np.asarray(jax_fused_color_stage(jnp.asarray(img), jnp.asarray(fp), jnp.asarray(ip),
                                           out_dtype=jnp.float32))
    ak.reset_launches()
    out = _twin(img, fp, ip).numpy()
    assert ak.LAUNCHES["fused_color_stage"] == 0  # CPU tensors take the twin
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(3, 32, 32), (2, 17, 9), (1, 40, 24)])
def test_k5_twin_matches_the_jnp_chain(shape):
    """tests/test_augment_kernel.py's reference chain (rgb_to_hsv/hsv_to_rgb)."""
    B, H, W = shape
    img = np.random.default_rng(B * H).uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    fp, ip = _params(B, H, W, GATES_ON, seed=H)
    chain = jax.jit(_ref_chain, static_argnums=(3, 4))  # one program for the batch's samples
    ref = np.stack([np.asarray(chain(jnp.asarray(img[j]), fp[j], ip[j], H, W))
                    for j in range(B)])
    np.testing.assert_allclose(_twin(img, fp, ip).numpy(), ref, atol=1e-5, rtol=0)


def test_k5_twin_rounds_once_to_bf16():
    B, H, W = 2, 12, 12
    img = np.random.default_rng(3).uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    fp, ip = _params(B, H, W, GATES_ON, seed=4)
    out = _twin(img, fp, ip, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, _twin(img, fp, ip).to(torch.bfloat16), rtol=0, atol=0)


def test_k5_wrapper_refuses_other_devices():
    x = torch.zeros(1, 4, 4, 3, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ak.fused_color_stage(x, torch.zeros(1, 8, device="meta"),
                             torch.zeros(1, 12, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# geometry with the same draws
# ---------------------------------------------------------------------------

# fp32: the same arithmetic (cos/sin may differ in the last bit); bf16: the
# lerp weights round to bf16 on both sides, and a coordinate that lands on a
# rounding point can round the other way: a few bf16 ulps at 1 (2**-8)
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


def _img(dtype, B=8, H=20, W=28, seed=0):
    x = np.random.default_rng(seed).uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("deg", [-37.0, 12.5, 45.0])
def test_rotate_batch_rows_matches_jax(dtype, deg):
    xj, xt = _img(dtype)
    a = np.float32(np.radians(deg))
    ref = np.asarray(J.rotate_batch_rows(xj, jnp.float32(a), max_deg=45.0).astype(jnp.float32))
    out = A.rotate_batch_rows(xt, torch.tensor(a), max_deg=45.0).float().numpy()
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotate_matches_jax(dtype):
    """The unpadded reflect-index rotation (groups that do not divide B)."""
    xj, xt = _img(dtype, B=3)
    a = np.float32(np.radians(-100.0))
    ref = np.asarray(jax.vmap(lambda im: J.rotate(im, jnp.float32(a)))(xj).astype(jnp.float32))
    out = A.rotate(xt, torch.tensor(a)).float().numpy()
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scales", [(1.0, 1.0), (1.3, 1.9), (2.0, 1.05)])
def test_zoom_batch_rows_matches_jax(dtype, scales):
    xj, xt = _img(dtype)
    sy, sx = (np.float32(s) for s in scales)
    ref = np.asarray(J.zoom_batch_rows(xj, jnp.float32(sy), jnp.float32(sx)).astype(jnp.float32))
    out = A.zoom_batch_rows(xt, torch.tensor(sy), torch.tensor(sx)).float().numpy()
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sigma", [0.0, 0.7, 2.0])
def test_gaussian_blur_batch_matches_jax(dtype, sigma):
    xj, xt = _img(dtype)
    ref = np.asarray(J.gaussian_blur_batch(xj, jnp.float32(sigma)).astype(jnp.float32))
    out = A.gaussian_blur_batch(xt, torch.tensor(np.float32(sigma))).float().numpy()
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=0)


def test_hsv_round_trip_matches_jax():
    x = np.random.default_rng(5).uniform(0, 1, (4, 9, 11, 3)).astype(np.float32)
    x[0, 0, 0] = x[0, 0, 0, 0]  # a grey pixel: delta 0
    hsv_ref = np.asarray(J.rgb_to_hsv(jnp.asarray(x)))
    hsv = A.rgb_to_hsv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(hsv, hsv_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(A.hsv_to_rgb(torch.from_numpy(hsv_ref.copy())).numpy(),
                               np.asarray(J.hsv_to_rgb(jnp.asarray(hsv_ref))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_normalize_is_exact(dtype, xla_optimized):
    """Every uint8 value in every channel, against XLA's optimised program
    (its fused multiply-add)."""
    u8 = np.stack([np.arange(256, dtype=np.uint8).reshape(16, 16)] * 3, axis=-1)
    u8 = np.stack([u8, u8[::-1, :, ::-1]])
    ref = J.augment_batch(jnp.asarray(u8), jax.random.key(0), train=False,
                          out_dtype=getattr(jnp, dtype))
    out = A.augment_batch(torch.from_numpy(u8), train=False, out_dtype=getattr(torch, dtype))
    assert str(out.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the random draws, in distribution
# ---------------------------------------------------------------------------


def test_draw_color_params_gates_and_ranges():
    B, H, W = 20000, 224, 224
    fp, ip = ak.draw_color_params(torch.Generator().manual_seed(0), B, H, W, J.DEFAULT_CFG)
    jfp, jip = (np.asarray(a) for a in jax_draw_color_params(jax.random.key(0), B, H, W,
                                                             J.DEFAULT_CFG))
    fp, ip = fp.numpy(), ip.numpy()
    assert fp.shape == (B, 8) and fp.dtype == np.float32
    assert ip.shape == (B, 12) and ip.dtype == np.int32
    for col, p in ((0, 0.15), (1, 0.25), (5, 0.25)):  # do_dropout, do_hsv, do_bc
        assert set(np.unique(fp[:, col])) <= {0.0, 1.0}
        assert abs(fp[:, col].mean() - p) < 0.015, (col, fp[:, col].mean())
        assert abs(fp[:, col].mean() - jfp[:, col].mean()) < 0.02
    for col, hi in ((2, 10 / 180), (3, 15 / 255), (4, 10 / 255), (7, 0.2)):
        assert np.abs(fp[:, col]).max() <= hi + 1e-7
        assert abs(np.abs(fp[:, col]).mean() - hi / 2) < 0.02 * hi  # uniform on [-hi, hi]
    assert 0.8 - 1e-6 <= fp[:, 6].min() and fp[:, 6].max() <= 1.2 + 1e-6
    assert ip[:, 0].min() == 1 and ip[:, 0].max() == 5 and abs(ip[:, 0].mean() - 3) < 0.05
    assert (ip[:, 1] == 8).all()
    assert ip[:, 2:].min() == 0 and ip[:, 2:].max() == H - 8 - 1
    np.testing.assert_allclose(np.bincount(ip[:, 0])[1:] / B, np.bincount(jip[:, 0])[1:] / B,
                               atol=0.015)


@pytest.mark.parametrize("fused", [True, False])
def test_flip_rates(fused):
    """tests/test_augment_distribution.py's flip check on the port, on the K5
    path (its CPU twin) and on the per-sample chain."""
    B = 64
    img = torch.from_numpy(_structured_batch(B))
    hflips = vflips = total = 0
    for seed in range(6):
        out = A.augment_batch(img, torch.Generator().manual_seed(seed), train=True,
                              fused_color=fused).numpy()
        out = out * np.array([0.229, 0.224, 0.225]) + np.array([0.485, 0.456, 0.406])
        for i in range(B):
            total += 1
            hflips += out[i, 12:, -4:, 0].mean() < out[i, 12:, :4, 0].mean() - 0.1
            vflips += out[i, -4:, :, 0].mean() > out[i, :4, :, 0].mean() + 0.2
    assert 0.30 < hflips / total < 0.70, hflips / total
    assert 0.08 < vflips / total < 0.40, vflips / total


def test_rotate_and_blur_gate_rates():
    """Rotation p=.5 and blur p=.25 per sample: count the samples each
    grouped stage changed."""
    B, n = 64, 20
    img = torch.rand(B, 24, 24, 3)
    rot = blur = 0
    for seed in range(n):
        g = torch.Generator().manual_seed(seed)
        r = A._rotate_groups(img, g, A.DEFAULT_CFG)
        b = A._blur_groups(img, g, A.DEFAULT_CFG)
        rot += int(((r - img).abs().amax(dim=(1, 2, 3)) > 1e-3).sum())
        blur += int(((b - img).abs().amax(dim=(1, 2, 3)) > 1e-3).sum())
    assert abs(rot / (B * n) - 0.5) < 0.06, rot / (B * n)
    # a blur whose sigma is drawn near 0 changes nothing visible
    assert 0.15 < blur / (B * n) < 0.30, blur / (B * n)


def test_augment_batch_runs_both_recipes_in_both_dtypes():
    img = torch.from_numpy(_structured_batch(12))
    for recipe in ("default", "sentence"):
        for dtype in (torch.float32, torch.bfloat16):
            a = A.augment_batch(img, torch.Generator().manual_seed(1), True, dtype, recipe=recipe)
            b = A.augment_batch(img, torch.Generator().manual_seed(1), True, dtype, recipe=recipe)
            c = A.augment_batch(img, torch.Generator().manual_seed(2), True, dtype, recipe=recipe)
            assert a.shape == img.shape and a.dtype == dtype
            assert torch.isfinite(a.float()).all()
            assert torch.equal(a, b)  # a generator seed fixes the draws
            assert (a.float() - c.float()).abs().max() > 0.1
    with pytest.raises(ValueError, match="Generator"):
        A.augment_batch(img, None, train=True)
