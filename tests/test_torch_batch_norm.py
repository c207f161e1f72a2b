"""K6 and the port's BatchNorm modules against skinjax's: the twins of
``bn_stats``/``bn_grad_stats`` against skinjax's Pallas kernels (interpret
mode, as ``tests/test_fused_bn.py`` runs them); the port's
``FusedBatchNorm2d``/``FusedBatchNorm1d`` against skinjax's
``FusedBatchNorm``, train and eval (forward, the gradients of x, weight and
bias, the running statistics), fp32 and bf16; the native flax-biased
``BatchNorm2d``/``BatchNorm1d`` against flax's ``nn.BatchNorm``;
``fuse_batch_norms``; the first launch's plan and the layouts the wrappers
take. skinjax's (..., C) array is the port's ``movedim(-1, 1)`` view: the
channels_last layout the kernels read on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from skinjax.ops.fused_bn import FusedBatchNorm as JaxFusedBatchNorm
from skinjax.ops.pallas.bn_kernels import bn_grad_stats as jax_bn_grad_stats
from skinjax.ops.pallas.bn_kernels import bn_stats as jax_bn_stats
from skinjax_torch.models.backbones.resnet import resnet18
from skinjax_torch.ops import batch_norm as tbn
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

# skinjax's (..., C) shapes: a conv map (N, H, W, C) and a token batch (B, N, C)
SHAPES = {"map": (4, 5, 6, 24), "tokens": (3, 7, 32)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    C = shape[-1]
    p = dict(scale=(rng.normal(size=C) * 0.5 + 1.0).astype(np.float32),
             bias=rng.normal(size=C).astype(np.float32),
             mean=rng.normal(size=C).astype(np.float32),
             var=(rng.random(C) + 0.5).astype(np.float32))
    return x, dy, p


def _port_view(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """skinjax's (..., C) array as the port's channels-at-dim-1 view."""
    return torch.from_numpy(a).to(dtype).movedim(-1, 1)


@pytest.mark.parametrize("layout", list(SHAPES))
def test_twins_match_skinjax_kernels(layout):
    """The twins' (Σx, Σx²) and (Σdy, Σdy·x) against skinjax's Pallas
    kernels on the same rows, rtol 1e-5."""
    x, dy, _ = _draw(SHAPES[layout], 0)
    got = tbn.bn_stats_reference(_port_view(x)) + tbn.bn_grad_stats_reference(
        _port_view(x), _port_view(dy))
    want = jax_bn_stats(jnp.asarray(x)) + jax_bn_grad_stats(jnp.asarray(x), jnp.asarray(dy))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (x.shape[-1],)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    # the wrappers take the twins for CPU tensors and count no launch
    tbn.reset_launches()
    assert all(torch.equal(a, b) for a, b in zip(tbn.bn_stats(_port_view(x)), got[:2]))
    assert tbn.LAUNCHES == {"bn_stats": 0, "bn_grad_stats": 0}


def _jax_bn(module, x, dy, p):
    """skinjax/flax BatchNorm on x: y, the gradients of sum(y·dy) in x,
    scale and bias, and the running statistics after the call."""
    params = {"scale": jnp.asarray(p["scale"]), "bias": jnp.asarray(p["bias"])}
    stats = {"mean": jnp.asarray(p["mean"]), "var": jnp.asarray(p["var"])}

    def f(xv, pv):
        y, upd = module.apply({"params": pv, "batch_stats": stats}, xv, mutable=["batch_stats"])
        return y, upd.get("batch_stats", stats)

    y, vjp, after = jax.vjp(f, x, params, has_aux=True)
    gx, gp = vjp(jnp.asarray(dy).astype(y.dtype))
    return (np.asarray(y.astype(jnp.float32)), np.asarray(gx.astype(jnp.float32)),
            np.asarray(gp["scale"]), np.asarray(gp["bias"]),
            np.asarray(after["mean"]), np.asarray(after["var"]))


def _port_bn(module, x, dy, p, train, dtype):
    """The port's module on the same inputs, the same outputs in skinjax's
    (..., C) layout."""
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(p["scale"]))
        module.bias.copy_(torch.from_numpy(p["bias"]))
        module.running_mean.copy_(torch.from_numpy(p["mean"]))
        module.running_var.copy_(torch.from_numpy(p["var"]))
    module.train(train)
    xt = _port_view(x, dtype).detach().requires_grad_(True)
    y = module(xt)
    y.backward(_port_view(dy, dtype))
    back = (y.detach(), xt.grad)
    return tuple(t.movedim(1, -1).float().numpy() for t in back) + (
        module.weight.grad.numpy(), module.bias.grad.numpy(),
        module.running_mean.numpy(), module.running_var.numpy())


def _bf16_tol(ref: np.ndarray) -> float:
    """Two bf16 roundings of the largest value (2⁻⁸ each)."""
    return 2 * 2.0 ** -8 * float(np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layout", list(SHAPES))
def test_fused_batch_norm_matches_skinjax(layout, train, dtype):
    """The port's fused module (2-D on the map, 1-D on the tokens' (B, C, N)
    view) against skinjax's ``FusedBatchNorm``: y, dx, dweight, dbias and the
    running statistics, fp32 within 1e-5 (relative to the largest value). In
    bf16: y and dx within two bf16 roundings of the largest value; the
    weight gradients, per channel, within 2⁻⁶ of the sum of their terms'
    magnitudes Σ|dy·x̂| and Σ|dy| (skinjax's eval route sums them in bf16);
    the statistics within 1e-5."""
    x, dy, p = _draw(SHAPES[layout], 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = _jax_bn(JaxFusedBatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5),
                  jnp.asarray(x).astype(jdt), dy, p)
    cls = tbn.FusedBatchNorm2d if layout == "map" else tbn.FusedBatchNorm1d
    got = _port_bn(cls(x.shape[-1]), x, dy, p, train, getattr(torch, dtype))
    rows = x.reshape(-1, x.shape[-1]).astype(np.float64)
    mean, var = (rows.mean(0), rows.var(0)) if train else (p["mean"], p["var"])
    xhat = (rows - mean) / np.sqrt(var + 1e-5)
    terms = {"dweight": np.abs(dy.reshape(rows.shape) * xhat).sum(0),
             "dbias": np.abs(dy.reshape(rows.shape)).sum(0)}
    names = ("y", "dx", "dweight", "dbias", "running_mean", "running_var")
    for name, g, r in zip(names, got, ref):
        if dtype == "bfloat16" and name in terms:
            assert (np.abs(g - r) <= 2.0 ** -6 * terms[name]).all(), name
            continue
        if dtype == "bfloat16" and name in ("y", "dx"):
            tol = _bf16_tol(r)
        else:
            tol = 1e-5 * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("layout", list(SHAPES))
def test_native_batch_norm_matches_flax(layout):
    """The native route (``BatchNorm2d``/``BatchNorm1d``, torch's batch norm
    with flax's biased running variance) against flax's ``nn.BatchNorm`` in
    train mode, fp32 within 1e-4 (another variance formula than the fast one
    flax and K6 share)."""
    x, dy, p = _draw(SHAPES[layout], 2)
    ref = _jax_bn(flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5),
                  jnp.asarray(x), dy, p)
    cls = tbn.BatchNorm2d if layout == "map" else tbn.BatchNorm1d
    got = _port_bn(cls(x.shape[-1]), x, dy, p, True, torch.float32)
    for name, g, r in zip(("y", "dx", "dweight", "dbias", "mean", "var"), got, ref):
        np.testing.assert_allclose(g, r, atol=1e-4 * max(1.0, float(np.abs(r).max())), rtol=0,
                                   err_msg=name)


def test_fuse_batch_norms_keeps_state_dict():
    """``fuse_batch_norms`` swaps every BatchNorm of a ResNet-18 for the
    fused module in place: the same objects, parameters and buffers, the same
    ``state_dict``; one train-mode forward's outputs and statistics on both
    routes agree in fp32 within 1e-4 (the two variance formulas differ)."""
    torch.manual_seed(0)
    native = resnet18()
    before = {k: v.clone() for k, v in native.state_dict().items()}
    params = dict(native.named_parameters())
    fused = tbn.fuse_batch_norms(resnet18())
    fused.load_state_dict(before)
    same = tbn.fuse_batch_norms(native)
    assert same is native
    assert dict(native.named_parameters()) == params
    assert native.state_dict().keys() == before.keys()
    assert all(torch.equal(native.state_dict()[k], v) for k, v in before.items())
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in native.modules())
    assert tbn.count_batch_norms(native) == n_bn == 20
    assert all(isinstance(m, tbn.FusedBatchNorm2d) for m in native.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    ref = resnet18()
    ref.load_state_dict(before)
    x = torch.randn(4, 64, 64, 3)
    out = [m.train()(x) for m in (fused, ref)]
    np.testing.assert_allclose(out[0].detach().numpy(), out[1].detach().numpy(), atol=1e-4,
                               rtol=1e-4)
    for k in before:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(fused.state_dict()[k].numpy(),
                                       ref.state_dict()[k].numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("M,C,itemsize,aligned", [
    (1_605_632, 64, 2, True), (3136, 1024, 2, True), (6273, 96, 4, True), (99, 24, 2, False),
    (7, 5, 4, True), (1, 1, 2, True)])
def test_plan_covers_the_rows(M, C, itemsize, aligned):
    """The first launch's plan: 16-byte loads where C and the pointers allow,
    tx a power of two ≤ 32 dividing the block, segments that cover every row
    once (none empty) in multiples of the block's rows, about TARGET_BLOCKS
    blocks, at most 65535 segments."""
    vec, tx, seg_rows, n_seg = tbn.plan(M, C, itemsize, aligned)
    assert vec == (16 // itemsize if aligned and C % (16 // itemsize) == 0 else 1)
    assert tx & (tx - 1) == 0 and tx <= 32 and tbn.THREADS % tx == 0
    assert seg_rows % (tbn.THREADS // tx) == 0
    assert seg_rows * (n_seg - 1) < M <= seg_rows * n_seg <= 65535 * seg_rows
    tiles = -(-(C // vec) // tx)
    assert tiles * n_seg <= 2 * tbn.TARGET_BLOCKS


def test_layouts():
    """The kernels' layout: a channels_last map and the (B, C, N) view of
    (B, N, C) tokens are rows of C contiguous channels; a plain NCHW map is
    not, and the wrappers' check raises on it (the card never copies
    silently). The train route keeps a channels_last map's layout in y and
    dx."""
    nchw = torch.randn(2, 8, 3, 3)
    cl = nchw.contiguous(memory_format=torch.channels_last)
    tokens = torch.randn(2, 9, 8).transpose(1, 2)
    assert tbn.rows_contiguous(cl) and tbn.rows_contiguous(tokens)
    assert not tbn.rows_contiguous(nchw)
    with pytest.raises(ValueError, match="rows of C contiguous"):
        tbn._check("x", nchw, nchw)
    tbn._check("x", cl, cl)
    x = cl.clone().requires_grad_(True)
    y = tbn.FusedBatchNorm2d(8).train()(x)
    y.backward(torch.ones_like(y).contiguous(memory_format=torch.channels_last))
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert x.grad.is_contiguous(memory_format=torch.channels_last)
