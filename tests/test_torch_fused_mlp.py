"""The port's fused token-MLP twins (``skinjax_torch/ops/fused_mlp.py``: K9's
exact-GELU MLP and K10's StarReLU MLP, forward and recompute backward)
against skinjax's Pallas kernels, run in interpret mode as
``tests/test_fused_mlp.py`` runs them, and against skinjax's XLA oracles
``mlp_gelu_reference``/``mlp_star_reference``: the same numpy inputs from a
seed, forward and every gradient (the scalars ds/db and the biases db1/db2
included), at token counts below and above skinjax's 512-row tile and not
multiples of it, with D ≠ D2. fp32 at skinjax's own tolerances (forward
1e-5; gradients 2e-4 of max(1, |max|)), bf16 at its bf16 ones (2e-2; 6e-2).
Then: zero dy rows add exactly nothing to any weight gradient; the autograd
functions return the twins' gradients in the arguments' dtypes; the wrappers
reject a wrong dtype or shape. The CUDA kernels themselves are held against
these twins by ``chip_smoke.py`` on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skinjax.ops.pallas import fused_mlp as jax_mlp
from skinjax_torch.ops import fused_mlp as fm
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

# (T, D, H, D2): below one tile; above it and ragged, with D ≠ D2
SHAPES = [(37, 16, 64, 16), (600, 32, 64, 48)]
TOL = {"float32": (1e-5, 2e-4), "bfloat16": (2e-2, 6e-2)}  # (forward, gradients)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind, T, D, H, D2, seed):
    """numpy fp32 arguments (x, w1, b1 or s, w2 or b, ...) and a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D))
    w1 = rng.normal(size=(D, H)) / np.sqrt(D)
    w2 = rng.normal(size=(H, D2)) / np.sqrt(H)
    dy = rng.normal(size=(T, D2))
    if kind == "gelu":
        args = (x, w1, 0.1 * rng.normal(size=H), w2, 0.1 * rng.normal(size=D2))
    else:
        args = (x, w1, np.array([1.3]), np.array([-0.2]), w2)
    return [a.astype(np.float32) for a in args], dy.astype(np.float32)


def _scalar_arg(kind, i):
    """K10's s and b (positions 2, 3) stay fp32 in every dtype."""
    return kind == "star" and i in (2, 3)


def _jax_side(kind, args, dy, dtype):
    """skinjax's kernel (interpret mode) and oracle: {fn: (y, grads)}."""
    jargs = [jnp.asarray(a) if _scalar_arg(kind, i) else jnp.asarray(a, JDT[dtype])
             for i, a in enumerate(args)]
    fns = {"kernel": jax_mlp.mlp_gelu if kind == "gelu" else jax_mlp.mlp_star,
           "reference": (jax_mlp.mlp_gelu_reference if kind == "gelu"
                         else jax_mlp.mlp_star_reference)}
    out = {}
    for name, fn in fns.items():

        def value_and_vjp(*a, fn=fn):
            y, vjp = jax.vjp(fn, *a)
            return y, vjp(jnp.asarray(dy, y.dtype))

        out[name] = jax.jit(value_and_vjp)(*jargs)  # one compile beats eager dispatch here
    return out


def _port_side(kind, args, dy, dtype):
    """The twins: (y, grads) in skinjax's order, gradients cast to the
    arguments' dtypes as the autograd functions do."""
    targs = [torch.tensor(a) if _scalar_arg(kind, i) else torch.tensor(a).to(TDT[dtype])
             for i, a in enumerate(args)]
    tdy = torch.tensor(dy).to(TDT[dtype])
    if kind == "gelu":
        y = fm.mlp_gelu_plain(*targs)
        grads = fm.mlp_gelu_bwd_plain(targs[0], tdy, targs[1], targs[2], targs[3])
    else:
        y = fm.mlp_star_plain(*targs)
        grads = fm.mlp_star_bwd_plain(targs[0], tdy, *targs[1:])
    return y, [g.to(t.dtype) for g, t in zip(grads, targs)]


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _assert_grad_close(got, want, atol, name):
    """skinjax's gradient check: |got - want| / max(1, max |want|) <= atol."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "T{}-D{}-H{}-D2{}".format(*s))
@pytest.mark.parametrize("kind", ["gelu", "star"])
def test_twins_match_skinjax(kind, shape, dtype):
    """Forward and every gradient of the twins against skinjax's Pallas
    kernel (interpret mode) and its XLA oracle, dtypes and shapes included."""
    args, dy = _inputs(kind, *shape, seed=sum(shape))
    fwd_tol, grad_tol = TOL[dtype]
    y, grads = _port_side(kind, args, dy, dtype)
    names = (["dx", "dw1", "db1", "dw2", "db2"] if kind == "gelu"
             else ["dx", "dw1", "ds", "db", "dw2"])
    for side, (jy, jgrads) in _jax_side(kind, args, dy, dtype).items():
        assert str(y.dtype).endswith(str(jy.dtype)) and tuple(y.shape) == jy.shape, side
        np.testing.assert_allclose(_f32(y), _f32(jy), atol=fwd_tol, rtol=fwd_tol, err_msg=side)
        for name, g, jg in zip(names, grads, jgrads):
            assert str(g.dtype).endswith(str(jg.dtype)) and tuple(g.shape) == jg.shape, name
            _assert_grad_close(_f32(g), _f32(jg), grad_tol, f"{side} {name}")


@pytest.mark.parametrize("kind", ["gelu", "star"])
def test_zero_dy_rows_add_nothing(kind):
    """Rows whose dy is zero add exactly nothing: changing x on those rows
    leaves every weight, bias and scalar gradient bit-identical, and the
    other rows' dx too (the kernels pad ragged token tiles with such rows)."""
    T, D, H, D2 = 77, 16, 64, 32
    args, dy = _inputs(kind, T, D, H, D2, seed=5)
    dy[20:45] = 0.0
    bwd = fm.mlp_gelu_bwd_plain if kind == "gelu" else fm.mlp_star_bwd_plain
    t = [torch.tensor(a) for a in args]
    x2 = t[0].clone()
    x2[20:45] = torch.randn(25, D, generator=torch.Generator().manual_seed(1)) * 3
    if kind == "gelu":
        a, b = (bwd(x, torch.tensor(dy), t[1], t[2], t[3]) for x in (t[0], x2))
    else:
        a, b = (bwd(x, torch.tensor(dy), *t[1:]) for x in (t[0], x2))
    for ga, gb in zip(a[1:], b[1:]):
        assert torch.equal(ga, gb)
    keep = torch.ones(T, dtype=torch.bool)
    keep[20:45] = False
    assert torch.equal(a[0][keep], b[0][keep])


@pytest.mark.parametrize("kind", ["gelu", "star"])
def test_autograd_functions_return_the_twins_gradients(kind):
    """``mlp_gelu``/``mlp_star`` on (B, N, D) bf16 inputs: the forward is
    the twin's, and the backward hands each argument the twin's gradient in
    that argument's dtype (fp32 scalars stay fp32)."""
    args, dy = _inputs(kind, 2 * 19, 32, 64, 32, seed=3)
    leaves = [torch.tensor(a).requires_grad_() if _scalar_arg(kind, i)
              else torch.tensor(a).to(torch.bfloat16).requires_grad_()
              for i, a in enumerate(args)]
    x3 = leaves[0].reshape(2, 19, 32)
    fn = fm.mlp_gelu if kind == "gelu" else fm.mlp_star
    y = fn(x3, *leaves[1:])
    tdy = torch.tensor(dy).to(torch.bfloat16).reshape(2, 19, 32)
    y.backward(tdy)
    det = [t.detach() for t in leaves]
    if kind == "gelu":
        want_y = fm.mlp_gelu_plain(*det)
        want = fm.mlp_gelu_bwd_plain(det[0], tdy.reshape(38, 32), det[1], det[2], det[3])
    else:
        want_y = fm.mlp_star_plain(*det)
        want = fm.mlp_star_bwd_plain(det[0], tdy.reshape(38, 32), *det[1:])
    assert y.shape == (2, 19, 32) and y.dtype == torch.bfloat16
    assert torch.equal(y.reshape(38, 32), want_y)
    for leaf, g in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        assert torch.equal(leaf.grad, g.to(leaf.dtype))


def test_wrappers_reject_bad_arguments():
    """A wrong shape, a dtype that differs from x's, non-fp32 or misshapen
    scalars and a misshapen dy raise before any arithmetic; the kernels'
    own width rule (multiples of 16) raises too."""
    x, w1, w2 = torch.randn(5, 16), torch.randn(16, 32), torch.randn(32, 16)
    b1, b2, s, b = torch.randn(32), torch.randn(16), torch.ones(1), torch.zeros(1)
    with pytest.raises(ValueError, match="w1"):
        fm.mlp_gelu_fwd(x, torch.randn(8, 32), b1, w2, b2)
    with pytest.raises(ValueError, match="b2"):
        fm.mlp_gelu_fwd(x, w1, b1, w2, torch.randn(32))
    with pytest.raises(TypeError, match="w2"):
        fm.mlp_gelu_fwd(x, w1, b1, w2.double(), b2)
    with pytest.raises(TypeError, match="floating"):
        fm.mlp_star_fwd(x.long(), w1, s, b, w2)
    with pytest.raises(ValueError, match="s must be float32"):
        fm.mlp_star_fwd(x, w1, s.double(), b, w2)
    with pytest.raises(ValueError, match="b must be float32"):
        fm.mlp_star_fwd(x, w1, s, torch.zeros(2), w2)
    with pytest.raises(ValueError, match="dy"):
        fm.mlp_star_bwd(x, torch.randn(5, 8), w1, s, b, w2)
    with pytest.raises(ValueError, match="multiples of 16"):
        fm._dims(torch.randn(5, 24), torch.randn(24, 32), torch.randn(32, 24))
