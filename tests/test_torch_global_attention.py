"""The port's global attention core (K12's plain twins, the CPU path of
``skinjax_torch.ops.global_attention``) against skinjax's
``ops/pallas/global_attention.py``, run as its own tests run it on the CPU
(the Pallas kernels in interpret mode): the same numpy inputs on both sides;
the output and the stored probabilities P of ``_fwd_core``, the stored-P
backward ``_bwd_p_core``, the recompute backward ``window_attention._bwd_core``
(its global call: one window, no window mask) and ``jax.vjp`` of
``attention_core`` on both of skinjax's backward routes; with no extras, a
bias, a key mask, a probability multiplier and all three; fp32 and bf16.
Then the autograd.Function against autograd of the reference in float64, the
route the residual limit picks, and ``MultiheadAttention``'s three routes
against skinjax's ``MultiHeadAttention``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skinjax.ops import attention as jattn
from skinjax.ops.pallas import global_attention as jga
from skinjax.ops.pallas import window_attention as jwa
from skinjax_torch.ops import global_attention as tga
from skinjax_torch.ops.attention import MultiheadAttention
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name: (B, N, C, heads, bias, kmask, pmult)
CASES = {
    "plain": (2, 17, 128, 2, False, False, False),
    "bias": (2, 17, 128, 2, True, False, False),
    "kmask": (2, 50, 128, 4, False, True, False),
    "pmult": (1, 50, 128, 4, False, False, True),
    "all": (2, 50, 128, 4, True, True, True),
}
# the recompute backward's cases: the above (64 channels a head with 2 heads,
# 32 with 4) and a ragged N
RECOMPUTE_CASES = dict(CASES, ragged=(2, 37, 128, 4, True, True, True))


def _inputs(case, seed):
    B, N, C, h, bias, kmask, pmult = RECOMPUTE_CASES[case]
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k, v, do = (rng.normal(size=(B, N, C)).astype(f) for _ in range(4))
    b = (rng.normal(size=(h, N, N)) * 0.5).astype(f) if bias else None
    km = None
    if kmask:  # BERT padding: the last keys of the first sample dropped
        km = np.zeros((B, N), f)
        km[0, N - 5:] = -1e9
    pm = None
    if pmult:  # broadcast dropout at keep 0.8: keep / 0.8 or 0
        pm = (np.where(rng.uniform(size=(N, N)) < 0.8, 1.0, 0.0) / 0.8).astype(f)
    return (q, k, v), do, b, km, pm, h


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _torch(a, dtype=torch.float32, grad=False):
    if a is None:
        return None
    return torch.tensor(a, dtype=dtype, requires_grad=grad)


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _bf16_ulp(x):
    """One bf16 ulp at the magnitude of max |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _skinjax_p(p, B, h, N):
    """skinjax's stored P (n_groups, B, heads/group, Np, Np) as (B, h, N, N)."""
    p = np.asarray(p)
    return p.transpose(1, 0, 2, 3, 4).reshape(B, h, *p.shape[-2:])[:, :, :N, :N]


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(out, ref, dtype, name):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-5, rtol=1e-5, err_msg=name)
    else:
        r = _f32(ref)
        np.testing.assert_allclose(_f32(out), r, atol=2 * _bf16_ulp(r), rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_p_match_skinjax(case, dtype):
    """o and P against skinjax's ``_fwd_core(emit_p=True)`` (the Pallas
    kernel ``attention_core`` runs), and o against its einsum reference."""
    (q, k, v), _, b, km, pm, h = _inputs(case, seed=1)
    B, N, _ = q.shape
    jdt, tdt = DTYPES[dtype]
    ref_o, ref_p = jga._fwd_core(*(_jax(a, jdt) for a in (q, k, v)), _jax(b), _jax(km), _jax(pm),
                                 num_heads=h, emit_p=True)
    tga.reset_launches()
    out, p = tga.global_attention_fwd(*(_torch(a, tdt) for a in (q, k, v)), _torch(b), _torch(km),
                                      _torch(pm), h, emit_p=True)
    assert sum(tga.LAUNCHES.values()) == 0  # CPU tensors take the twins
    assert out.dtype == tdt and out.shape == q.shape and p.dtype == torch.float32
    _close(out, ref_o, dtype, "o")
    np.testing.assert_allclose(p.numpy(), _skinjax_p(ref_p, B, h, N), atol=1e-5, rtol=1e-5)
    ref = jga.attention_core_reference(*(_jax(a, jdt) for a in (q, k, v)), h, _jax(b), _jax(km),
                                       _jax(pm))
    mine = tga.attention_core_reference(*(_torch(a, tdt) for a in (q, k, v)), h, _torch(b),
                                        _torch(km), _torch(pm))
    _close(mine, ref, dtype, "reference")
    if dtype == "float32":  # the reference scales q first: equal in fp32 up to rounding
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_backward_twin_matches_bwd_p_core(case, dtype):
    """dq, dk, dv and dbias from the backward twin against skinjax's
    ``_bwd_p_core`` on the same P; fp32 within 1e-5, bf16 within 2 ulps."""
    (q, k, v), do, b, km, pm, h = _inputs(case, seed=2)
    B, N, _ = q.shape
    jdt, tdt = DTYPES[dtype]
    _, jp = jga._fwd_core(*(_jax(a, jdt) for a in (q, k, v)), _jax(b), _jax(km), _jax(pm),
                          num_heads=h, emit_p=True)
    ref = jga._bwd_p_core(*(_jax(a, jdt) for a in (q, k, v, do)), jp, _jax(pm), num_heads=h,
                          has_bias=b is not None)
    p = torch.tensor(_skinjax_p(jp, B, h, N))
    out = tga.global_attention_bwd(*(_torch(a, tdt) for a in (q, k, v, do)), p, _torch(pm), h,
                                   b is not None)
    assert (out[3] is None) == (b is None)
    for name, o, r in zip(("dq", "dk", "dv", "dbias"), out, ref):
        if r is None:
            continue
        assert o.shape == r.shape, name
        _close(o, r, "float32" if name == "dbias" else dtype, name)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_vjp(case):
    """Through the autograd.Function: dq, dk, dv, dbias against ``jax.vjp``
    of skinjax's ``attention_core`` (its stored-P backward), fp32."""
    (q, k, v), do, b, km, pm, h = _inputs(case, seed=3)
    args = [_jax(a) for a in (q, k, v)] + [_jax(b)]
    y, vjp = jax.vjp(lambda q, k, v, b: jga.attention_core(q, k, v, b, _jax(km), _jax(pm), h),
                     *args)
    ref = vjp(jnp.asarray(do))
    targs = [_torch(a, grad=True) for a in (q, k, v)]
    bias = _torch(b, grad=True)
    out = tga.attention_core(*targs, bias, _torch(km), _torch(pm), h)
    out.backward(torch.tensor(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5, rtol=1e-5)
    grads = [t.grad for t in targs] + ([bias.grad] if bias is not None else [])
    for name, o, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_function_matches_reference_float64(case):
    """The Function's forward and backward against autograd through the
    plain reference, in float64 (the twins sum in float64 there)."""
    (q, k, v), do, b, km, pm, h = _inputs(case, seed=4)
    f64 = torch.float64
    a1 = [_torch(a, f64, grad=True) for a in (q, k, v)] + [_torch(b, f64, grad=True)]
    a2 = [_torch(a, f64, grad=True) for a in (q, k, v)] + [_torch(b, f64, grad=True)]
    km, pm = _torch(km, f64), _torch(pm, f64)
    y1 = tga.attention_core(*a1[:4], km, pm, h)
    y2 = tga.attention_core_reference(*a2[:3], h, a2[3], km, pm)
    assert y1.dtype == f64
    np.testing.assert_allclose(y1.detach().numpy(), y2.detach().numpy(), atol=1e-12, rtol=1e-10)
    g = torch.tensor(do, dtype=f64)
    y1.backward(g)
    y2.backward(g)
    for t1, t2 in zip(a1, a2):
        if t1 is not None:
            np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(), atol=1e-12, rtol=1e-9)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(RECOMPUTE_CASES))
def test_recompute_twin_matches_bwd_core(case, dtype):
    """dq, dk, dv and dbias from the recompute backward's twin against
    skinjax's ``_bwd_core`` (n_win=1, no window mask, with the kmask and
    pmult) on the forward's inputs, no P; fp32 within 1e-5, bf16 within 2
    ulps (dbias fp32 both ways)."""
    (q, k, v), do, b, km, pm, h = _inputs(case, seed=7)
    jdt, tdt = DTYPES[dtype]
    ref = jwa._bwd_core(*(_jax(a, jdt) for a in (q, k, v, do)), _jax(b), None, num_heads=h,
                        has_bias=b is not None, has_mask=False, n_win=1, kmask=_jax(km),
                        pmult=_jax(pm))
    tga.reset_launches()
    out = tga.global_attention_bwd_recompute(*(_torch(a, tdt) for a in (q, k, v, do)),
                                             _torch(b), _torch(km), _torch(pm), h, b is not None)
    assert sum(tga.LAUNCHES.values()) == 0
    assert (out[3] is None) == (b is None)
    ref = (*ref[:3], ref[4])  # _bwd_core's ``of`` output is not ported
    for name, o, r in zip(("dq", "dk", "dv", "dbias"), out, ref):
        if r is None:
            continue
        assert o.shape == r.shape and o.dtype == (torch.float32 if name == "dbias" else tdt)
        _close(o, r, "float32" if name == "dbias" else dtype, name)


@pytest.mark.parametrize("case", list(RECOMPUTE_CASES))
def test_recompute_route_matches_jax_vjp(case, monkeypatch):
    """Through the autograd.Function on the recompute route (the residual
    limit at 0): dq, dk, dv, dbias against ``jax.vjp`` of skinjax's
    ``attention_core`` on its recompute route (``SKINJAX_GLOBATTN=pallas``,
    ``SKINJAX_GLOBATTN_BWD=recompute``), fp32 within 1e-5; and the port's two
    routes give the same gradients exactly (one P, the same arithmetic)."""
    monkeypatch.setenv("SKINJAX_GLOBATTN", "pallas")
    monkeypatch.setenv("SKINJAX_GLOBATTN_BWD", "recompute")
    (q, k, v), do, b, km, pm, h = _inputs(case, seed=8)
    args = [_jax(a) for a in (q, k, v)] + [_jax(b)]
    y, vjp = jax.vjp(lambda q, k, v, b: jga.attention_core(q, k, v, b, _jax(km), _jax(pm), h),
                     *args)
    ref = vjp(jnp.asarray(do))

    def grads():
        targs = [_torch(a, grad=True) for a in (q, k, v)] + [_torch(b, grad=True)]
        out = tga.attention_core(*targs, _torch(km), _torch(pm), h)
        out.backward(torch.tensor(do))
        return out, [t.grad for t in targs if t is not None]

    stored_out, stored = grads()
    monkeypatch.setattr(tga, "STORE_P_MAX_BYTES", 0)
    tga.reset_launches()
    out, rec = grads()
    assert sum(tga.LAUNCHES.values()) == 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5, rtol=1e-5)
    assert torch.equal(out, stored_out)
    for name, o, s, r in zip(("dq", "dk", "dv", "dbias"), rec, stored, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5, err_msg=name)
        assert torch.equal(o, s), name


def test_residual_limit_routes(monkeypatch):
    """The backward reads a stored P where its residual B·h·N²·4 is at most
    skinjax's 256 MB and recomputes it above; the forward keeps P only then,
    and keeps none without a gradient. At B=1, 16 heads, N=1024 (64 MB) both
    routes run and agree."""
    def q_of(B, N, C=1024):
        return torch.zeros(B, N, C)

    assert tga.STORE_P_MAX_BYTES == 256 * 1024 * 1024
    assert tga.stores_p(q_of(32, 197), 16)  # BEiT-large at B=32: 79.5 MB
    assert tga.stores_p(q_of(4, 1024), 16)  # exactly 256 MB
    assert not tga.stores_p(q_of(5, 1024), 16)
    assert not tga.stores_p(q_of(32, 512, 768), 12)  # BERT-base at T=512, B=32: 402 MB
    assert not tga.stores_p(q_of(8, 1024, 768), 12)  # GPT-2 at T=1024, B=8: 402 MB

    emitted, calls = [], {"global_attention_bwd": 0, "global_attention_bwd_recompute": 0}
    fwd = tga.global_attention_fwd

    def spy_fwd(*a):
        emitted.append(a[-1])
        return fwd(*a)

    monkeypatch.setattr(tga, "global_attention_fwd", spy_fwd)
    for name in calls:
        def spy(*a, _fn=getattr(tga, name), _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(tga, name, spy)
    rng = np.random.default_rng(9)
    B, N, C, h = 1, 1024, 64, 16  # 4 channels a head keeps the CPU products small
    q, k, v, do = (torch.tensor(rng.normal(size=(B, N, C)).astype(np.float32))
                   for _ in range(4))
    results = []
    for limit in (tga.STORE_P_MAX_BYTES, B * h * N * N * 4 - 1):
        monkeypatch.setattr(tga, "STORE_P_MAX_BYTES", limit)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        tga.attention_core(*leaves, None, None, None, h).backward(do)
        results.append([t.grad for t in leaves])
    assert emitted == [True, False]
    assert calls == {"global_attention_bwd": 1, "global_attention_bwd_recompute": 1}
    for a, b in zip(*results):
        assert torch.equal(a, b)
    with torch.no_grad():
        tga.attention_core(q, k, v, None, None, None, h)
    assert emitted == [True, False, False]


def test_packed_slices_and_bad_devices():
    """Slices of a packed qkv projection keep their row stride (3C); a
    tensor whose rows are not evenly spaced has none; the kernels take CPU
    (their twins) or CUDA tensors only."""
    qkv = torch.zeros(2, 5, 3 * 8)
    assert tga._row_stride(qkv[..., :8]) == 24
    assert tga._row_stride(qkv[..., 8:16]) == 24
    assert tga._row_stride(torch.zeros(2, 8, 5).transpose(1, 2)) is None
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tga.global_attention_fwd(x, x, x, None, None, None, 1, emit_p=False)


def _mha_pair(D, h, seed):
    """skinjax's MultiHeadAttention with random parameters, and the port's
    module holding the same ones in the packed layout."""
    rng = np.random.default_rng(seed)
    f = np.float32
    params = {n: {"kernel": (rng.normal(size=(D, D)) / np.sqrt(D)).astype(f),
                  "bias": (0.1 * rng.normal(size=(D,))).astype(f)}
              for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    port = MultiheadAttention(D, h)
    with torch.no_grad():
        port.in_proj_weight.copy_(torch.tensor(np.concatenate(
            [params[n]["kernel"].T for n in ("q_proj", "k_proj", "v_proj")])))
        port.in_proj_bias.copy_(torch.tensor(np.concatenate(
            [params[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")])))
        port.out_proj.weight.copy_(torch.tensor(params["out_proj"]["kernel"].T))
        port.out_proj.bias.copy_(torch.tensor(params["out_proj"]["bias"]))
    return jattn.MultiHeadAttention(D, h), {"params": params}, port


@pytest.mark.parametrize("route", ["self (K12)", "cross", "mask"])
def test_multihead_attention_matches_skinjax(route):
    """Sq == Skv without a mask goes through K12 (its twin here); Sq != Skv,
    and a boolean mask, through plain PyTorch; each against skinjax."""
    D, h, B, S = 64, 4, 2, 9
    jmod, variables, port = _mha_pair(D, h, seed=5)
    rng = np.random.default_rng(6)
    skv = 5 if route == "cross" else S
    q = rng.normal(size=(B, S, D)).astype(np.float32)
    kv = rng.normal(size=(B, skv, D)).astype(np.float32)
    mask = None
    if route == "mask":
        mask = rng.uniform(size=(B, 1, S, S)) > 0.3
        mask[..., 0] = True  # every query attends to something
    ref = jmod.apply(variables, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                     mask=None if mask is None else jnp.asarray(mask))
    tga.reset_launches()
    with torch.no_grad():
        out = port(torch.tensor(q), torch.tensor(kv), torch.tensor(kv),
                   None if mask is None else torch.tensor(mask))
    assert sum(tga.LAUNCHES.values()) == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# the recompute core as K7's padded entry runs it: name -> (windows, N, C,
# heads, bias, mask planes); window b adds mask[b % planes]
WINDOW_CASES = {"bias, 4 masks": (8, 49, 64, 2, True, 4),
                "mask only, 2 masks": (4, 49, 96, 3, False, 2)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_core_twin_matches_bwd_core(case, dtype):
    """dq, dk, dv, of and dbias from ``window_core_bwd``'s twin against
    skinjax's ``_bwd_core`` with its window mask (n_win planes, Pallas in
    interpret mode): fp32 within 1e-5, bf16 within 2 ulps (dbias fp32 both
    ways)."""
    nB, N, C, h, bias, n_mask = WINDOW_CASES[case]
    rng = np.random.default_rng(9)
    f = np.float32
    q, k, v, do = (rng.normal(size=(nB, N, C)).astype(f) for _ in range(4))
    b = (rng.normal(size=(h, N, N)) * 0.5).astype(f) if bias else None
    m = np.where(rng.uniform(size=(n_mask, N, N)) > 0.8, -100.0, 0.0).astype(f)
    m[:, np.arange(N), np.arange(N)] = 0.0
    jdt, tdt = DTYPES[dtype]
    ref = jwa._bwd_core(*(_jax(a, jdt) for a in (q, k, v, do)), _jax(b), _jax(m), num_heads=h,
                        has_bias=bias, has_mask=True, n_win=n_mask)
    tga.reset_launches()
    out = tga.window_core_bwd(*(_torch(a, tdt) for a in (q, k, v, do)), _torch(b), _torch(m),
                              h, bias)
    assert sum(tga.LAUNCHES.values()) == 0
    assert (out[4] is None) == (b is None)
    for name, o, r in zip(("dq", "dk", "dv", "of", "dbias"), out, ref):
        if r is None:
            continue
        assert o.shape == r.shape and o.dtype == (torch.float32 if name == "dbias" else tdt)
        _close(o, r, "float32" if name == "dbias" else dtype, name)


def test_bias_groups():
    """The recompute backward sums a bias gradient over groups of windows:
    at Swin-tiny's stage 0 (4096 windows, 2 key tiles, 3 heads) enough for
    ~1056 blocks; never more groups than batches, one where there is one
    batch; the planes' scratch within the stored-P limit at the kernel's
    widest N."""
    assert tga.bias_groups(4096, 49, 3) == 176
    assert tga.bias_groups(64, 49, 24) == 22
    assert tga.bias_groups(3, 49, 3) == 3
    assert tga.bias_groups(1, 197, 16) == 1
    for h in (1, 2, 16, 64):
        N = tga.MAX_TOKENS
        assert tga.bias_groups(65535, N, h) * h * N * N * 4 <= tga.STORE_P_MAX_BYTES


def test_forward_bias_rows():
    """The bias as the forward kernel reads it: for bfloat16 at N not a
    multiple of 4, rows padded by zeros to a multiple of 4 floats (16-byte
    aligned), the values unchanged; the bias as it is for float32, or where
    N is a multiple of 4."""
    rng = np.random.default_rng(0)
    for h, N, ld in ((16, 197, 200), (4, 50, 52), (2, 49, 52)):
        bias = torch.from_numpy(rng.standard_normal((h, N, N), dtype=np.float32))
        padded, got_ld = tga.fwd_bias(bias, torch.bfloat16)
        assert got_ld == ld and padded.shape == (h, N, ld) and padded.is_contiguous()
        assert torch.equal(padded[..., :N], bias) and not padded[..., N:].any()
        same, got_ld = tga.fwd_bias(bias, torch.float32)
        assert same is bias and got_ld == N
    bias = torch.zeros((12, 512, 512))
    same, got_ld = tga.fwd_bias(bias, torch.bfloat16)
    assert same is bias and got_ld == 512
    assert tga.fwd_bias(None, torch.bfloat16) == (None, 0)


def test_stored_p_scratch_and_groups():
    """What the stored-P backward's wrapper allocates: float32 keeps the ds
    plane its CUDA-core launches pass on; bfloat16 a row statistic and, with
    a bias gradient, the planes (in 64 × 64 tiles) of as many groups of
    batches as give its key-column launch ~STORED_P_GROUP_BLOCKS blocks of 64
    keys (the groups the kernel forms, ceil(B / groups) batches each), at
    least one, at most B, their scratch within the stored-P limit wherever
    one plane is."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert tga.bwd_scratch_shapes(f32, 32, 197, 16, True) == ((32, 16, 197, 197), None)
    assert tga.bwd_scratch_shapes(bf16, 32, 197, 16, False) == ((32, 16, 197), None)
    assert tga.stored_p_groups(32, 197, 16) == 4
    assert tga.bwd_scratch_shapes(bf16, 32, 197, 16, True) == ((32, 16, 197), (4, 16, 256, 256))
    assert tga.bwd_scratch_shapes(bf16, 1, 197, 16, True) == ((1, 16, 197), (1, 16, 256, 256))
    assert tga.bwd_scratch_shapes(bf16, 4, 50, 4, True) == ((4, 4, 50), (4, 4, 64, 64))
    for B in range(1, 70):
        for N, h in ((1, 1), (50, 4), (197, 16), (512, 12), (1024, 1), (1024, 64)):
            g = tga.stored_p_groups(B, N, h)
            assert 1 <= g <= B
            _, planes = tga.bwd_scratch_shapes(bf16, B, N, h, True)
            n, _, Np, _ = planes
            per = -(-B // n)  # the kernel's batches a group, from the count it is given
            assert n == -(-B // per) and n <= g and Np % 64 == 0 and 0 <= Np - N < 64
            assert n == 1 or n * h * Np * Np * 4 <= tga.STORE_P_MAX_BYTES
