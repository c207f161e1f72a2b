"""The port's pooled attention core (K11's plain twins, the CPU path of
``skinjax_torch.ops.pooled_attention``) against skinjax's
``ops/pallas/pooled_attention.py``, run as its own tests run it on the CPU
(the Pallas kernels in interpret mode): the same numpy inputs on both sides;
the output and the stored probabilities P of ``_fwd_core``, the stored-P
backward ``_bwd_core`` and ``jax.vjp`` of ``pooled_attention``, at a square
key grid, a rectangular one with a ragged query count, and MViTv2's 96
channels a head; fp32 and bf16. Then skinjax's query-chunked call against the
port's unchunked one, the autograd.Function against autograd of the
reference in float64, and the wrapper's checks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skinjax.ops.pallas import pooled_attention as jpa
from skinjax_torch.ops import pooled_attention as tpa
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name: (B, heads, Nq, (Kh, Kw), hd)
CASES = {
    "square": (2, 2, 49, (7, 7), 16),
    "ragged": (2, 2, 20, (3, 5), 16),   # Kh != Kw catches swapped indices
    "hd96": (1, 1, 64, (4, 4), 96),     # MViTv2's head width
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """q, k, v, bias_h, bias_w, do as fp32 numpy arrays (drawn once a case)."""
    B, h, Nq, (Kh, Kw), hd = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    mk = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return (mk(B, h, Nq, hd), mk(B, h, Kh * Kw, hd), mk(B, h, Kh * Kw, hd),
            mk(B, h, Nq, Kh, scale=0.5), mk(B, h, Nq, Kw, scale=0.5), mk(B, h, Nq, hd))


def _torch(a, dtype=torch.float32, grad=False):
    return torch.tensor(a, dtype=dtype, requires_grad=grad)


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(out, ref, dtype, name):
    """fp32: atol/rtol 2e-5; bf16: each element within one bf16 ulp of the
    reference's magnitude (8 significant bits: a sum taken in another order
    can round the other way)."""
    o, r = _f32(out), _f32(ref)
    assert o.shape == r.shape, name
    if dtype == "float32":
        np.testing.assert_allclose(o, r, atol=2e-5, rtol=2e-5, err_msg=name)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
        assert (np.abs(o - r) <= ulp).all(), (name, float(np.abs(o - r).max()))


def _norm_close(out, ref, name):
    """Within 1e-4 of the reference's 2-norm (the bias gradients)."""
    o, r = _f32(out), _f32(ref)
    assert o.shape == r.shape, name
    assert np.linalg.norm(o - r) <= 1e-4 * np.linalg.norm(r), name


def _unpad_p(p, B, h, Nq, Nk):
    """skinjax's stored P (B·h, Npq, Npk) as (B, h, Nq, Nk)."""
    p = np.asarray(p)
    return p.reshape(B, h, *p.shape[1:])[:, :, :Nq, :Nk]


@functools.lru_cache(maxsize=None)
def _skinjax_fwd(case, dtype):
    """skinjax's ``_fwd_core(emit_p=True)`` (the Pallas kernel, interpret
    mode) → (o, P as (B, h, Nq, Nk))."""
    q, k, v, bh, bw, _ = _inputs(case)
    B, h, Nq, k_size, _ = CASES[case]
    jdt = DTYPES[dtype][0]
    fwd = jax.jit(functools.partial(jpa._fwd_core, k_size=k_size, emit_p=True))
    o, p = fwd(*(jnp.asarray(a, jdt) for a in (q, k, v, bh, bw)))
    return np.asarray(o.astype(jnp.float32)), _unpad_p(p, B, h, Nq, k_size[0] * k_size[1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_p_match_skinjax(case, dtype):
    """o and P against skinjax's ``_fwd_core(emit_p=True)``, and the port's
    copy of the einsum reference against skinjax's; a twin call counts no
    launch."""
    q, k, v, bh, bw, _ = _inputs(case)
    k_size = CASES[case][3]
    jdt, tdt = DTYPES[dtype]
    ref_o, ref_p = _skinjax_fwd(case, dtype)
    tpa.reset_launches()
    out, p = tpa.pooled_attention_fwd(*(_torch(a, tdt) for a in (q, k, v, bh, bw)), k_size,
                                      emit_p=True)
    assert sum(tpa.LAUNCHES.values()) == 0  # CPU tensors take the twins
    assert out.dtype == tdt and out.shape == q.shape and p.dtype == torch.float32
    _close(out, ref_o, dtype, "o")
    np.testing.assert_allclose(p.numpy(), ref_p, atol=2e-5, rtol=2e-5)
    ref = jax.jit(jpa.pooled_attention_reference, static_argnums=5)(
        *(jnp.asarray(a, jdt) for a in (q, k, v, bh, bw)), k_size)
    mine = tpa.pooled_attention_reference(*(_torch(a, tdt) for a in (q, k, v, bh, bw)), k_size)
    _close(mine, ref, dtype, "reference")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_backward_twin_matches_bwd_core(case, dtype):
    """dq, dk, dv, dbias_h and dbias_w from the backward twin against
    skinjax's ``_bwd_core`` on the same P: dq, dk, dv as the forward's o,
    the bias gradients (fp32 on both sides) within 1e-4 of their norm."""
    q, k, v, _, _, do = _inputs(case)
    B, h, Nq, k_size, _ = CASES[case]
    jdt, tdt = DTYPES[dtype]
    _, p = _skinjax_fwd(case, dtype)
    Npq, Npk = jpa._pad16(Nq), jpa._pad16(p.shape[-1])
    p_pad = np.zeros((B * h, Npq, Npk), np.float32)
    p_pad[:, :Nq, :p.shape[-1]] = p.reshape(B * h, Nq, -1)
    ref = jax.jit(functools.partial(jpa._bwd_core, k_size=k_size))(
        *(jnp.asarray(a, jdt) for a in (q, k, v, do)), jnp.asarray(p_pad))
    tpa.reset_launches()
    got = tpa.pooled_attention_bwd(*(_torch(a, tdt) for a in (q, k, v, do)), torch.tensor(p),
                                   k_size)
    assert sum(tpa.LAUNCHES.values()) == 0
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == tdt
        _close(g, r, dtype, name)
    for name, g, r in zip(("dbias_h", "dbias_w"), got[3:], ref[3:]):
        assert g.dtype == torch.float32
        _norm_close(g, r, name)


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_matches_jax_vjp(case):
    """fp32: the port's ``pooled_attention`` under autograd against
    ``jax.vjp`` of skinjax's (the custom VJP: P stored by the forward kernel,
    read by the backward kernel), all five cotangents; and autograd's
    gradients are the backward twin's on the forward twin's P, exactly."""
    q, k, v, bh, bw, do = _inputs(case)
    k_size = CASES[case][3]
    out, ref = jax.jit(lambda dy, *a: (lambda o, vjp: (o, vjp(dy)))(
        *jax.vjp(lambda *x: jpa.pooled_attention(*x, k_size), *a)))(
        *(jnp.asarray(a) for a in (do, q, k, v, bh, bw)))
    ts = [_torch(a, grad=True) for a in (q, k, v, bh, bw)]
    tpa.reset_launches()
    o = tpa.pooled_attention(*ts, k_size)
    o.backward(torch.from_numpy(do))
    assert sum(tpa.LAUNCHES.values()) == 0
    _close(o, out, "float32", "o")
    for name, t, r in zip(("dq", "dk", "dv"), ts, ref):
        _close(t.grad, r, "float32", name)
    for name, t, r in zip(("dbias_h", "dbias_w"), ts[3:], ref[3:]):
        _norm_close(t.grad, r, name)
    _, p = tpa.pooled_attention_plain(*(_torch(a) for a in (q, k, v, bh, bw)), k_size)
    twin = tpa.pooled_attention_bwd_plain(*(_torch(a) for a in (q, k, v, do)), p, k_size)
    for t, w in zip(ts, twin):
        assert torch.equal(t.grad, w)


def test_chunked_equals_unchunked():
    """skinjax's query-chunked call (two chunks, folded into the head axis)
    against the port's single call: the same function."""
    q, k, v, bh, bw, _ = _inputs("ragged")
    k_size = CASES["ragged"][3]
    ref = jpa.pooled_attention_chunked(*(jnp.asarray(a) for a in (q, k, v, bh, bw)), k_size, 2)
    out = tpa.pooled_attention(*(_torch(a) for a in (q, k, v, bh, bw)), k_size)
    _close(out, ref, "float32", "chunked")


def test_autograd_function_is_the_reference_gradient():
    """float64, where rounding is far below the check: the forward and all
    five gradients of ``pooled_attention`` equal autograd through the einsum
    reference, at the rectangular ragged case (bf16 casts are the identity
    in float64). Without a gradient, the forward keeps no P."""
    q, k, v, bh, bw, do = _inputs("ragged")
    k_size = CASES["ragged"][3]
    a = [_torch(x, torch.float64, grad=True) for x in (q, k, v, bh, bw)]
    b = [_torch(x, torch.float64, grad=True) for x in (q, k, v, bh, bw)]
    dy = torch.from_numpy(do).double()
    oa = tpa.pooled_attention(*a, k_size)
    ob = tpa.pooled_attention_reference(*b, k_size)
    torch.testing.assert_close(oa, ob, atol=1e-12, rtol=1e-10)
    oa.backward(dy)
    ob.backward(dy)
    for x, y in zip(a, b):
        assert x.grad.dtype == torch.float64
        torch.testing.assert_close(x.grad, y.grad, atol=1e-11, rtol=1e-9)
    with torch.no_grad():
        o = tpa.pooled_attention(*a, k_size)
    assert o.grad_fn is None


def test_wrapper_checks():
    """What the CUDA path checks before a launch (the kernel's limits, the
    shapes and dtypes), on CPU tensors, and the device dispatch."""
    x = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype)  # noqa: E731
    q, kv = x(1, 2, 4, 8), x(1, 2, 6, 8)
    bh, bw = x(1, 2, 4, 2), x(1, 2, 4, 3)
    assert len(tpa._check(q, kv, kv, (2, 3), bh, bw)) == 5
    assert len(tpa._check(q, kv, kv, (2, 3))) == 3
    with pytest.raises(ValueError, match="1024 keys"):  # Nk = 1056
        tpa._check(q, x(1, 2, 1056, 8), x(1, 2, 1056, 8), (33, 32))
    with pytest.raises(ValueError, match="128 channels"):
        tpa._check(x(1, 2, 4, 160), x(1, 2, 6, 160), x(1, 2, 6, 160), (2, 3))
    with pytest.raises(ValueError, match="bias_h"):
        tpa._check(q, kv, kv, (2, 3), x(1, 2, 4, 3), bw)
    with pytest.raises(ValueError, match="bias_w"):
        tpa._check(q, kv, kv, (2, 3), bh, x(1, 2, 4, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="k is"):  # Nk != Kh·Kw
        tpa._check(q, kv, kv, (3, 3))
    with pytest.raises(TypeError):
        tpa._check(q.double(), kv, kv, (2, 3))
    m = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpa.pooled_attention_fwd(m, m, m, m[..., :2], m[..., :2], (2, 2), emit_p=False)


def test_backward_scratch():
    """The backward kernel's fp32 scratch: float32 keeps ds, a plane the
    size of P; bfloat16 one row statistic a query row (its tensor-core
    kernels keep ds in registers)."""
    assert tpa.bwd_scratch_shape(torch.float32, 64, 4, 196, 196) == (64, 4, 196, 196)
    assert tpa.bwd_scratch_shape(torch.bfloat16, 64, 4, 196, 196) == (64, 4, 196)
    assert tpa.bwd_scratch_shape(torch.bfloat16, 64, 1, 3136, 196) == (64, 1, 3136)
