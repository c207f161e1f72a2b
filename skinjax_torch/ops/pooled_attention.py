"""MViTv2's pooled attention core as hand-written CUDA kernels: the forward,
which also emits the fp32 softmax probabilities P when asked, and the
stored-probabilities backward, with the decomposed relative-position bias.

Counterpart of ``skinjax/ops/pallas/pooled_attention.py`` (K11):

  kernel                   CUDA entry point (csrc/pooled_attention.cu)   replaces (Pallas TPU kernel)
  pooled_attention_fwd     skinjax_pooled_attention_fwd                  pooled_attention.py _fwd_core
  pooled_attention_bwd     skinjax_pooled_attention_bwd                  pooled_attention.py _bwd_core

``pooled_attention(q, k, v, bias_h, bias_w, k_size)`` is a
``torch.autograd.Function`` with skinjax's signature and layouts: q
``(B, h, Nq, hd)``, k and v ``(B, h, Nk, hd)``, bias_h ``(B, h, Nq, Kh)``
and bias_w ``(B, h, Nq, Kw)`` with ``Nk = Kh·Kw`` and ``k_size = (Kh, Kw)``.
The score of query n and key m is ``(q·kᵀ)·scale + bias_h[n, m // Kw] +
bias_w[n, m % Kw]``; the bias is never expanded to ``(B, h, Nq, Nk)``. All
five tensors are differentiable (the bias gradients are per sample, summed
over the key grid's columns and rows). It returns ``(B, h, Nq, hd)`` in q's
dtype (float32 or bfloat16 on the card). It rounds at the Pallas kernel's
points: the scale multiplies the fp32 scores, then the two bias terms are
added in fp32, in that order; P is fp32 and is cast to q's dtype before
``·v``; the backward casts P before ``dv``, keeps ``dp``, ``ds`` and the bias
gradients in fp32, casts ``ds`` before ``dq`` and ``dk`` and scales those
after the product. (skinjax's einsum reference, ``pooled_attention_reference``
here too, scales q in the input dtype instead.)

skinjax's TPU guards are not carried over (ROADMAP.md, "Leave out of the
port"): the VMEM and residual caps of ``pooled_attn_ok``, the query chunking
of ``pooled_attention_chunked`` and the ``SKINJAX_POOLED_ATTN`` scopes. A
grid over query tiles needs no chunks, and every call stores P for its
backward. The kernels' own limits are ``Nk ≤ MAX_KEYS`` (the fp32 kernels
keep whole score rows in shared memory; the bf16 kernels on the tensor cores
stream them) and ``hd ≤ MAX_HEAD_DIM``. The backward takes an fp32 scratch
whose size depends on the dtype (``bwd_scratch_shape``): the fp32 kernels
pass ds, a plane the size of P, from one launch to the next; the bf16
kernels keep ds in registers and pass one statistic a query row,
rowsum(dp·P).

``pooled_attention_plain`` and ``pooled_attention_bwd_plain`` are the plain
PyTorch twins, rounding at the same points. The wrappers dispatch on the
device of q: a CPU tensor goes to the twin, a CUDA tensor launches the kernel
or raises. There is no fallback from a failed build or launch. ``LAUNCHES``
counts calls that launched a kernel (a twin call is not counted).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from skinjax_torch.ops import acc_dtype, check_tensor

LAUNCHES: Dict[str, int] = {"pooled_attention_fwd": 0, "pooled_attention_bwd": 0}

MAX_KEYS = 1024
MAX_HEAD_DIM = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "skinjax_pooled_attention_error_string": ([_I], ctypes.c_char_p),
    "skinjax_pooled_attention_fwd": ([_I] + [_P] * 7 + [_I] * 6 + [_F, _P], _I),
    "skinjax_pooled_attention_bwd": ([_I] + [_P] * 11 + [_I] * 6 + [_F, _P], _I),
}
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library():
    """The kernels' shared library, built with nvcc on first use (raises if
    the build fails)."""
    from skinjax_torch.ops import build

    return build.load("pooled_attention", _SIGNATURES)


def pooled_attention_reference(q, k, v, bias_h, bias_w, k_size):
    """skinjax's einsum oracle: q scaled in its dtype (by the scale rounded
    to that dtype, as JAX's weakly typed scalar is), fp32 scores, the
    expanded bias added, P cast to q's dtype. Returns (B, h, Nq, hd)."""
    B, h, Nq, hd = q.shape
    Kh, Kw = k_size
    with torch.autocast(q.device.type, enabled=False):
        acc = acc_dtype(q.dtype)
        scale = torch.tensor(hd ** -0.5, dtype=q.dtype)
        s = torch.einsum("bhnd,bhmd->bhnm", (q * scale).to(acc), k.to(acc))
        bias = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(B, h, Nq, Kh * Kw)
        p = torch.softmax(s + bias.to(acc), dim=-1).to(q.dtype)
        return torch.einsum("bhnm,bhmd->bhnd", p.to(acc), v.to(acc)).to(q.dtype)


# ---------------------------------------------------------------------------
# plain twins (the reference for the kernels, and the CPU path)
# ---------------------------------------------------------------------------


def pooled_attention_plain(q, k, v, bias_h, bias_w, k_size: Sequence[int]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic in PyTorch ops → (o (B, h, Nq, hd) in
    q's dtype, P (B, h, Nq, Nk) fp32)."""
    dt, acc = q.dtype, acc_dtype(q.dtype)
    B, h, Nq, hd = q.shape
    Kh, Kw = k_size
    with torch.autocast(q.device.type, enabled=False):
        s = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * hd ** -0.5
        s = s.reshape(B, h, Nq, Kh, Kw)
        s = s + bias_h.to(acc)[..., :, None]
        s = (s + bias_w.to(acc)[..., None, :]).reshape(B, h, Nq, Kh * Kw)
        p = torch.softmax(s, dim=-1)
        return (p.to(dt).to(acc) @ v.to(acc)).to(dt), p


def pooled_attention_bwd_plain(q, k, v, do, p, k_size: Sequence[int]):
    """The backward kernel's arithmetic → (dq, dk, dv in q's dtype, dbias_h
    (B, h, Nq, Kh), dbias_w (B, h, Nq, Kw) fp32), what skinjax's
    ``_bwd_core`` returns."""
    dt, acc = q.dtype, acc_dtype(q.dtype)
    B, h, Nq, hd = q.shape
    Kh, Kw = k_size
    scale = hd ** -0.5
    with torch.autocast(q.device.type, enabled=False):
        qa, ka, va, doa = (t.to(acc) for t in (q, k, v, do))
        p = p.to(acc)
        dv = (p.to(dt).to(acc).transpose(-1, -2) @ doa).to(dt)
        dp = doa @ va.transpose(-1, -2)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        grid = ds.reshape(B, h, Nq, Kh, Kw)
        dbh, dbw = grid.sum(-1), grid.sum(-2)
        dsb = ds.to(dt).to(acc)
        dq = ((dsb @ ka) * scale).to(dt)
        dk = ((dsb.transpose(-1, -2) @ qa) * scale).to(dt)
        return dq, dk, dv, dbh, dbw


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, k_size, bias_h=None, bias_w=None):
    """Shapes, dtypes and limits the kernels take; raises on anything else.
    Returns q, k, v and the biases given, contiguous."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"pooled attention takes {_DTYPES}; got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, h, Nq, hd), got {tuple(q.shape)}")
    B, h, Nq, hd = q.shape
    Kh, Kw = (int(s) for s in k_size)
    Nk = Kh * Kw
    if Nk > MAX_KEYS or hd > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes at most {MAX_KEYS} keys and {MAX_HEAD_DIM} channels "
                         f"a head; got Nk={Nk}, hd={hd}")
    for name, t, shape in (("k", k, (B, h, Nk, hd)), ("v", v, (B, h, Nk, hd)),
                           ("bias_h", bias_h, (B, h, Nq, Kh)), ("bias_w", bias_w, (B, h, Nq, Kw))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype}{tuple(t.shape)} on {t.device}; expected "
                             f"{q.dtype}{shape} on {q.device} (k_size {(Kh, Kw)})")
    return tuple(t.contiguous() for t in (q, k, v, bias_h, bias_w) if t is not None)


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.skinjax_pooled_attention_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def _device(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"pooled attention takes CPU or CUDA tensors, got {q.device}")


def pooled_attention_fwd(q, k, v, bias_h, bias_w, k_size: Sequence[int], emit_p: bool
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(o (B, h, Nq, hd), P (B, h, Nq, Nk) fp32 when ``emit_p``, else None)
    from the forward kernel (CUDA) or its twin (CPU)."""
    if q.device.type == "cpu":
        o, p = pooled_attention_plain(q, k, v, bias_h, bias_w, k_size)
        return o, (p if emit_p else None)
    _device(q)
    q, k, v, bias_h, bias_w = _check(q, k, v, k_size, bias_h, bias_w)
    B, h, Nq, hd = q.shape
    Kh, Kw = (int(s) for s in k_size)
    o = torch.empty_like(q)
    p = (torch.empty((B, h, Nq, Kh * Kw), dtype=torch.float32, device=q.device) if emit_p
         else None)
    if q.numel() == 0:
        return o, p
    lib = library()
    err = lib.skinjax_pooled_attention_fwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias_h.data_ptr(), bias_w.data_ptr(), o.data_ptr(), None if p is None else p.data_ptr(),
        B, h, Nq, Kh, Kw, hd, hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, err, "pooled_attention_fwd")
    LAUNCHES["pooled_attention_fwd"] += 1
    return o, p


def bwd_scratch_shape(dtype: torch.dtype, B: int, h: int, Nq: int, Nk: int) -> Tuple[int, ...]:
    """The fp32 scratch the backward kernel takes: ds, a plane the size of P,
    for float32 (its CUDA-core kernels pass it from one launch to the next);
    the row statistic rowsum(dp·P), one value a query row, for bfloat16 (its
    tensor-core kernels keep ds in registers)."""
    return (B, h, Nq, Nk) if dtype == torch.float32 else (B, h, Nq)


def pooled_attention_bwd(q, k, v, do, p, k_size: Sequence[int]):
    """(dq, dk, dv, dbias_h fp32, dbias_w fp32) from the backward kernel
    (CUDA) or its twin (CPU); ``p`` is the forward's P."""
    if q.device.type == "cpu":
        return pooled_attention_bwd_plain(q, k, v, do, p, k_size)
    _device(q)
    B, h, Nq, hd = q.shape
    Kh, Kw = (int(s) for s in k_size)
    q, k, v = _check(q, k, v, k_size)
    check_tensor("do", do, (B, h, Nq, hd), q.dtype, q.device)
    check_tensor("p", p, (B, h, Nq, Kh * Kw), torch.float32, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbh = torch.empty((B, h, Nq, Kh), dtype=torch.float32, device=q.device)
    dbw = torch.empty((B, h, Nq, Kw), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_(), dbh, dbw
    scratch = torch.empty(bwd_scratch_shape(q.dtype, B, h, Nq, Kh * Kw), dtype=torch.float32,
                          device=q.device)
    lib = library()
    err = lib.skinjax_pooled_attention_bwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        p.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbh.data_ptr(),
        dbw.data_ptr(), scratch.data_ptr(), B, h, Nq, Kh, Kw, hd, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, err, "pooled_attention_bwd")
    LAUNCHES["pooled_attention_bwd"] += 1
    return dq, dk, dv, dbh, dbw


class _PooledAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias_h, bias_w, k_size, needs_grad):
        o, p = pooled_attention_fwd(q, k, v, bias_h, bias_w, k_size, emit_p=needs_grad)
        if needs_grad:
            ctx.save_for_backward(q, k, v, p)
        ctx.k_size = tuple(int(s) for s in k_size)
        ctx.bias_dtypes = (bias_h.dtype, bias_w.dtype)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, p = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            dq, dk, dv, dbh, dbw = pooled_attention_bwd(q, k, v, do.to(q.dtype).contiguous(), p,
                                                        ctx.k_size)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None, dv if need[2] else None,
                dbh.to(ctx.bias_dtypes[0]) if need[3] else None,
                dbw.to(ctx.bias_dtypes[1]) if need[4] else None, None, None)


def pooled_attention(q, k, v, bias_h, bias_w, k_size: Sequence[int]) -> torch.Tensor:
    """MViTv2's attention core (see the module docstring); differentiable in
    all five tensors. Where grad mode is on and an input needs a gradient,
    the forward keeps P for the backward."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, bias_h, bias_w))
    return _PooledAttention.apply(q, k, v, bias_h, bias_w, tuple(k_size), needs_grad)
