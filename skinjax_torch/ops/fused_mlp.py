"""The fused token MLP, fc1 → activation → fc2, as hand-written CUDA kernels:
the forward and the recompute backward, for CoaT-lite's serial blocks (exact
GELU, with biases) and CAFormer's MetaFormer blocks (bias-free, StarReLU).

Counterpart of ``skinjax/ops/pallas/fused_mlp.py``:

  kernel          CUDA entry point (csrc/fused_mlp.cu)   replaces (Pallas TPU kernel)
  mlp_gelu_fwd    skinjax_mlp_gelu_fwd                   fused_mlp.py _fwd_core (K9)
  mlp_gelu_bwd    skinjax_mlp_gelu_bwd                   fused_mlp.py _bwd_core (K9)
  mlp_star_fwd    skinjax_mlp_star_fwd                   fused_mlp.py _star_fwd_core (K10)
  mlp_star_bwd    skinjax_mlp_star_bwd                   fused_mlp.py _star_bwd_core (K10)

``mlp_gelu(x, w1, b1, w2, b2)`` and ``mlp_star(x, w1, s, b, w2)`` are
``torch.autograd.Function``s with skinjax's signatures and layouts: x
``(..., D)``, w1 ``(D, H)``, b1 ``(H,)``, w2 ``(H, D2)``, b2 ``(D2,)``, and
StarReLU's scalars s and b of shape ``(1,)``. Every argument is
differentiable. They return ``(..., D2)`` in x's dtype (float32 or bfloat16
on the card). They round at the Pallas kernels' points: ``pre`` is the fp32
product (plus b1, in x's dtype, for K9); the activation is fp32 and ``h`` is
cast to x's dtype before ``·w2``, whose fp32 sum takes K9's b2 before the
cast. The backward recomputes ``pre`` and ``h`` from x, casts ``dpre`` to x's
dtype before ``dw1`` and ``dx``, sums K9's ``db1`` from the fp32 ``dpre`` and
K10's ``ds = Σ dh·r²`` and ``db = Σ dh`` from fp32 terms; the weight and bias
gradients are fp32 sums, cast to the arguments' dtypes. The GELU is the erf
form (``torch.erf`` in the twins, ``erff`` in the kernel); skinjax's
Abramowitz–Stegun erf is a Mosaic workaround the port leaves out.

Launches. The bf16 forward is one launch on the tensor cores (``wgmma``): a
block of two warpgroups per 64 token rows takes its x rows once, then walks
128-wide hidden chunks: pre from ``wgmma`` with its fp32 accumulators in
registers, the activation on that fragment, round(h) through one swizzled
shared-memory tile, and h·w2 added to y's fp32 accumulators, which stay in
registers (y's columns split over the two warpgroups, and over blocks above
512 columns); no ``(T, H)`` tensor reaches device memory. Its tiles come by
TMA (tensor maps the kernel's C side encodes for each call). Where the blocks
fill less than half the SMs (a small batch), or where two splits turn one
and a half waves of blocks into three shorter ones, the hidden chunks are
split over blocks too, with ``splits · T · D2`` fp32 partials that a second
launch sums in split order (``skinjax_fused_mlp_scratch`` gives each call's
size). The fp32 forward keeps the CUDA-core kernel (32-row tiles, the output
in shared memory; split where T/32 tiles are fewer than the SMs).

Nothing is saved for the backward but the arguments: no ``(T, H)`` tensor is
kept between the forward and the backward. The bf16 backward runs five
products on the tensor cores and writes the hidden plane once, inside the
call: its scratch holds ``round(h)`` and ``round(dpre)`` as two bf16
``(T, H)`` planes (``T·H`` floats; 205 MB at CAFormer-b36's stage 0 at B=32),
the per-token-tile partials of db1 (``⌈T/128⌉·H``) or of ds and db, the
per-segment db2 partials, and, only where the dW output tiles are too few to
fill the card and the tokens are split into segments, ``segments · (D·H +
H·D2)`` fp32 dW partials. The fp32 backward keeps the CUDA-core kernels,
which recompute the plane: its scratch is the weight gradients'
per-segment fp32 partials, ``segments · (D·H + H·D2 + H + D2 + 2·H/hw)``
floats, where the kernel picks ``segments`` so that (H/hw) · segments is
about twice the SM count, and, where T/32 token tiles are fewer than the
SMs, ``splits · T · D`` dx partials. Each backward also takes the ``D·H +
H·D2 + H + D2 + 2`` floats of the summed gradients. Two calls on the same
inputs give bit-identical results (no atomics).

skinjax's routing knobs are not carried over (ROADMAP.md, "Leave out of the
port"): ``SKINJAX_CAFORMER_MLP``/``SKINJAX_COAT_MLP`` and the 48 MB threshold
chose the kernel on the TPU; the port's blocks run it everywhere. The
kernel's own limits: D, H and D2 are multiples of 16 and D, D2 ≤ 1024 (the
fp32 backward keeps (D, hw) and (hw, D2) fp32 tiles in shared memory).

``mlp_gelu_plain``/``mlp_gelu_bwd_plain`` and ``mlp_star_plain``/
``mlp_star_bwd_plain`` are the plain PyTorch twins, rounding at the same
points. The wrappers dispatch on the device of x: a CPU tensor goes to the
twin, a CUDA tensor launches the kernel or raises. There is no fallback from
a failed build or launch. ``LAUNCHES`` counts calls that launched a kernel (a
twin call is not counted).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from skinjax_torch.ops import acc_dtype

LAUNCHES: Dict[str, int] = {"mlp_gelu_fwd": 0, "mlp_gelu_bwd": 0, "mlp_star_fwd": 0,
                            "mlp_star_bwd": 0}

MAX_WIDTH = 1024
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "skinjax_fused_mlp_error_string": ([_I], ctypes.c_char_p),
    "skinjax_fused_mlp_scratch": ([_I] * 6 + [ctypes.POINTER(ctypes.c_longlong)], _I),
    "skinjax_mlp_gelu_fwd": ([_I] + [_P] * 7 + [_I] * 4 + [_P], _I),
    "skinjax_mlp_gelu_bwd": ([_I] + [_P] * 8 + [_I] * 4 + [_P], _I),
    "skinjax_mlp_star_fwd": ([_I] + [_P] * 7 + [_I] * 4 + [_P], _I),
    "skinjax_mlp_star_bwd": ([_I] + [_P] * 9 + [_I] * 4 + [_P], _I),
}
_CARD_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library():
    """The kernels' shared library, built with nvcc on first use (raises if
    the build fails)."""
    from skinjax_torch.ops import build

    return build.load("fused_mlp", _SIGNATURES)


def _gelu(p):
    return p * 0.5 * (1.0 + torch.erf(p * _INV_SQRT2))


def _dgelu(p):
    """d/dp of the exact GELU: Φ(p) + p·φ(p)."""
    cdf = 0.5 * (1.0 + torch.erf(p * _INV_SQRT2))
    pdf = torch.exp(-0.5 * p * p) * _INV_SQRT_2PI
    return cdf + p * pdf


# ---------------------------------------------------------------------------
# plain twins (the reference for the kernels, and the CPU path)
# ---------------------------------------------------------------------------


def mlp_gelu_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """K9's forward arithmetic in PyTorch ops → (..., D2) in x's dtype."""
    dt, acc = x.dtype, acc_dtype(x.dtype)
    with torch.autocast(x.device.type, enabled=False):
        pre = x.reshape(-1, x.shape[-1]).to(acc) @ w1.to(acc) + b1.to(acc)
        h = _gelu(pre).to(dt).to(acc)
        y = (h @ w2.to(acc) + b2.to(acc)).to(dt)
    return y.reshape(*x.shape[:-1], w2.shape[1])


def mlp_gelu_bwd_plain(x, dy, w1, b1, w2) -> Tuple[torch.Tensor, ...]:
    """K9's backward arithmetic → (dx (..., D) in x's dtype, dw1 (D, H),
    db1 (H,), dw2 (H, D2), db2 (D2,) fp32), what skinjax's ``_bwd_core``
    returns."""
    dt, acc = x.dtype, acc_dtype(x.dtype)
    with torch.autocast(x.device.type, enabled=False):
        xa = x.reshape(-1, x.shape[-1]).to(acc)
        dya = dy.reshape(-1, dy.shape[-1]).to(acc)
        pre = xa @ w1.to(acc) + b1.to(acc)
        h = _gelu(pre).to(dt).to(acc)
        dw2 = h.t() @ dya
        db2 = dya.sum(0)
        dpre = (dya @ w2.to(acc).t()) * _dgelu(pre)
        dpre_b = dpre.to(dt).to(acc)
        dw1 = xa.t() @ dpre_b
        db1 = dpre.sum(0)
        dx = (dpre_b @ w1.to(acc).t()).to(dt)
    return dx.reshape(x.shape), dw1, db1, dw2, db2


def mlp_star_plain(x, w1, s, b, w2) -> torch.Tensor:
    """K10's forward arithmetic in PyTorch ops → (..., D2) in x's dtype."""
    dt, acc = x.dtype, acc_dtype(x.dtype)
    with torch.autocast(x.device.type, enabled=False):
        r = torch.relu(x.reshape(-1, x.shape[-1]).to(acc) @ w1.to(acc))
        h = (s.to(acc) * r * r + b.to(acc)).to(dt).to(acc)
        y = (h @ w2.to(acc)).to(dt)
    return y.reshape(*x.shape[:-1], w2.shape[1])


def mlp_star_bwd_plain(x, dy, w1, s, b, w2) -> Tuple[torch.Tensor, ...]:
    """K10's backward arithmetic → (dx (..., D) in x's dtype, dw1 (D, H),
    ds (1,), db (1,), dw2 (H, D2) fp32), what skinjax's ``_star_bwd_core``
    returns."""
    dt, acc = x.dtype, acc_dtype(x.dtype)
    with torch.autocast(x.device.type, enabled=False):
        xa = x.reshape(-1, x.shape[-1]).to(acc)
        dya = dy.reshape(-1, dy.shape[-1]).to(acc)
        sa, ba = s.to(acc), b.to(acc)
        r = torch.relu(xa @ w1.to(acc))
        r2 = r * r
        h = (sa * r2 + ba).to(dt).to(acc)
        dw2 = h.t() @ dya
        dh = dya @ w2.to(acc).t()
        ds = (dh * r2).sum().reshape(1)
        db = dh.sum().reshape(1)
        dpre_b = (dh * (2.0 * sa * r)).to(dt).to(acc)
        dw1 = xa.t() @ dpre_b
        dx = (dpre_b @ w1.to(acc).t()).to(dt)
    return dx.reshape(x.shape), dw1, ds, db, dw2


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(x, w1, w2, biases=(), scalars=(), dy=None):
    """Shapes and dtypes the wrappers take, on either device; raises on
    anything else. ``biases``: K9's b1, b2 (x's dtype); ``scalars``: K10's s,
    b (fp32, shape (1,)); ``dy`` shaped like the output."""
    if not x.is_floating_point():
        raise TypeError(f"the fused MLP takes floating x; got {x.dtype}")
    if x.dim() < 1 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"x (..., D), w1 (D, H), w2 (H, D2); got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    D, H, D2 = x.shape[-1], w1.shape[1], w2.shape[1]
    shapes = [("w1", w1, (D, H)), ("w2", w2, (H, D2))]
    shapes += list(zip(("b1", "b2"), biases, ((H,), (D2,))))
    if dy is not None:
        shapes.append(("dy", dy, (*x.shape[:-1], D2)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape} "
                             f"(x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)})")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; x has {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; x is on {x.device}")
    for name, t in zip(("s", "b"), scalars):
        if tuple(t.shape) != (1,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 of shape (1,) on {x.device}; got "
                             f"{t.dtype}{tuple(t.shape)} on {t.device}")


def _card(*tensors):
    """The CUDA kernels' own limits; returns the tensors contiguous and
    16-byte aligned (a misaligned one is copied)."""
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"the fused MLP takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _CARD_DTYPES:
        raise TypeError(f"the fused MLP kernels take {_CARD_DTYPES}; got {x.dtype}")
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def _dims(x, w1, w2):
    T = x.numel() // x.shape[-1]
    D, H, D2 = x.shape[-1], w1.shape[1], w2.shape[1]
    if any(n % 16 for n in (D, H, D2)) or max(D, D2) > MAX_WIDTH:
        raise ValueError(f"the kernels take D, H and D2 that are multiples of 16 and D, D2 at most "
                         f"{MAX_WIDTH}; got D={D}, H={H}, D2={D2}")
    return T, D, H, D2


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.skinjax_fused_mlp_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scratch(lib, x, backward: bool, T, D, H, D2):
    """The kernels' fp32 scratch for one call (None where it needs none)."""
    n = ctypes.c_longlong()
    _raise(lib, lib.skinjax_fused_mlp_scratch(int(x.dtype == torch.bfloat16), int(backward), T, D,
                                              H, D2, ctypes.byref(n)), "fused MLP scratch query")
    return torch.empty(n.value, dtype=torch.float32, device=x.device) if n.value else None


def _bwd_buffers(lib, x, T, D, H, D2):
    """(dx, the partials' scratch, the summed fp32 gradients' buffer)."""
    return torch.empty_like(x), _scratch(lib, x, True, T, D, H, D2), _grads(x, D, H, D2)


def _grads(x, D, H, D2):
    """The summed fp32 gradients' buffer: dw1, dw2, db1, db2, ds, db."""
    return torch.empty(D * H + H * D2 + H + D2 + 2, dtype=torch.float32, device=x.device)


def _split(out, D, H, D2):
    """The summed gradients' buffer → dw1 (D, H), dw2 (H, D2), db1 (H,), db2
    (D2,), ds (1,), db (1,)."""
    dw1, dw2, db1, db2, ds, db = torch.split(out, [D * H, H * D2, H, D2, 1, 1])
    return dw1.view(D, H), dw2.view(H, D2), db1, db2, ds, db


def mlp_gelu_fwd(x, w1, b1, w2, b2) -> torch.Tensor:
    """y (..., D2) from K9's forward kernel (CUDA) or its twin (CPU)."""
    _check(x, w1, w2, (b1, b2))
    if x.device.type == "cpu":
        return mlp_gelu_plain(x, w1, b1, w2, b2)
    x, w1, b1, w2, b2 = _card(x, w1, b1, w2, b2)
    T, D, H, D2 = _dims(x, w1, w2)
    y = torch.empty((*x.shape[:-1], D2), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    lib = library()
    part = _scratch(lib, x, False, T, D, H, D2)
    err = lib.skinjax_mlp_gelu_fwd(int(x.dtype == torch.bfloat16), x.data_ptr(), w1.data_ptr(),
                                   b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                                   _ptr(part), T, D, H, D2, _stream(x))
    _raise(lib, err, "mlp_gelu_fwd")
    LAUNCHES["mlp_gelu_fwd"] += 1
    return y


def mlp_gelu_bwd(x, dy, w1, b1, w2):
    """(dx, dw1, db1, dw2, db2 fp32) from K9's backward kernels (CUDA) or
    its twin (CPU)."""
    _check(x, w1, w2, (b1,), dy=dy)
    if x.device.type == "cpu":
        return mlp_gelu_bwd_plain(x, dy, w1, b1, w2)
    x, dy, w1, b1, w2 = _card(x, dy, w1, b1, w2)
    T, D, H, D2 = _dims(x, w1, w2)
    if T == 0:
        dw1, dw2, db1, db2, _, _ = _split(_grads(x, D, H, D2).zero_(), D, H, D2)
        return torch.empty_like(x), dw1, db1, dw2, db2
    lib = library()
    dx, part, out = _bwd_buffers(lib, x, T, D, H, D2)
    err = lib.skinjax_mlp_gelu_bwd(int(x.dtype == torch.bfloat16), x.data_ptr(), dy.data_ptr(),
                                   w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dx.data_ptr(),
                                   part.data_ptr(), out.data_ptr(), T, D, H, D2, _stream(x))
    _raise(lib, err, "mlp_gelu_bwd")
    LAUNCHES["mlp_gelu_bwd"] += 1
    dw1, dw2, db1, db2, _, _ = _split(out, D, H, D2)
    return dx, dw1, db1, dw2, db2


def mlp_star_fwd(x, w1, s, b, w2) -> torch.Tensor:
    """y (..., D2) from K10's forward kernel (CUDA) or its twin (CPU)."""
    _check(x, w1, w2, scalars=(s, b))
    if x.device.type == "cpu":
        return mlp_star_plain(x, w1, s, b, w2)
    x, w1, s, b, w2 = _card(x, w1, s, b, w2)
    T, D, H, D2 = _dims(x, w1, w2)
    y = torch.empty((*x.shape[:-1], D2), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    lib = library()
    part = _scratch(lib, x, False, T, D, H, D2)
    err = lib.skinjax_mlp_star_fwd(int(x.dtype == torch.bfloat16), x.data_ptr(), w1.data_ptr(),
                                   s.data_ptr(), b.data_ptr(), w2.data_ptr(), y.data_ptr(),
                                   _ptr(part), T, D, H, D2, _stream(x))
    _raise(lib, err, "mlp_star_fwd")
    LAUNCHES["mlp_star_fwd"] += 1
    return y


def mlp_star_bwd(x, dy, w1, s, b, w2):
    """(dx, dw1, ds, db, dw2; the last four fp32) from K10's backward
    kernels (CUDA) or its twin (CPU)."""
    _check(x, w1, w2, scalars=(s, b), dy=dy)
    if x.device.type == "cpu":
        return mlp_star_bwd_plain(x, dy, w1, s, b, w2)
    x, dy, w1, s, b, w2 = _card(x, dy, w1, s, b, w2)
    T, D, H, D2 = _dims(x, w1, w2)
    if T == 0:
        dw1, dw2, _, _, ds, db = _split(_grads(x, D, H, D2).zero_(), D, H, D2)
        return torch.empty_like(x), dw1, ds, db, dw2
    lib = library()
    dx, part, out = _bwd_buffers(lib, x, T, D, H, D2)
    err = lib.skinjax_mlp_star_bwd(int(x.dtype == torch.bfloat16), x.data_ptr(), dy.data_ptr(),
                                   w1.data_ptr(), s.data_ptr(), b.data_ptr(), w2.data_ptr(),
                                   dx.data_ptr(), part.data_ptr(), out.data_ptr(), T, D, H, D2,
                                   _stream(x))
    _raise(lib, err, "mlp_star_bwd")
    LAUNCHES["mlp_star_bwd"] += 1
    dw1, dw2, _, _, ds, db = _split(out, D, H, D2)
    return dx, dw1, ds, db, dw2


class _MlpGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.b2_dtype = b2.dtype
        return mlp_gelu_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            dx, dw1, db1, dw2, db2 = mlp_gelu_bwd(x, dy.to(x.dtype), w1, b1, w2)
        return dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype)


class _MlpStar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, s, b, w2):
        ctx.save_for_backward(x, w1, s, b, w2)
        return mlp_star_fwd(x, w1, s, b, w2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, s, b, w2 = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            dx, dw1, ds, db, dw2 = mlp_star_bwd(x, dy.to(x.dtype), w1, s, b, w2)
        return dx, dw1.to(w1.dtype), ds, db, dw2.to(w2.dtype)


def mlp_gelu(x, w1, b1, w2, b2) -> torch.Tensor:
    """Fused ``x·w1 + b1 → exact GELU → ·w2 + b2`` over the token axis (see
    the module docstring); differentiable in all five."""
    return _MlpGelu.apply(x, w1, b1, w2, b2)


def mlp_star(x, w1, s, b, w2) -> torch.Tensor:
    """Fused bias-free ``x·w1 → s·relu² + b → ·w2`` (StarReLU MLP);
    differentiable in all five. s and b are fp32 of shape (1,)."""
    return _MlpStar.apply(x, w1, s, b, w2)
