"""Global (full-sequence) multi-head attention core as hand-written CUDA
kernels: the forward, which also emits the fp32 softmax probabilities P
when asked, the stored-probabilities backward and the recompute backward.

Counterpart of ``skinjax/ops/pallas/global_attention.py`` (K12):

  kernel                           CUDA entry point (csrc/global_attention.cu)   replaces (Pallas TPU kernel)
  global_attention_fwd             skinjax_global_attention_fwd                  global_attention.py _fwd_core
  global_attention_bwd             skinjax_global_attention_bwd                  global_attention.py _bwd_p_core
  global_attention_bwd_recompute   skinjax_global_attention_bwd_recompute        window_attention.py _bwd_core (n_win=1)
  window_core_bwd                  skinjax_global_attention_bwd_recompute        window_attention.py _bwd_core (window mask)

``attention_core(q, k, v, bias, kmask, pmult, num_heads)`` is a
``torch.autograd.Function`` with skinjax's signature and layouts: q, k, v
``(B, N, C)`` in the head-major channel layout (channel c belongs to head
``c // (C // num_heads)``; slices of a packed qkv projection are taken as
they are), bias ``(h, N, N)`` additive or None (differentiable), kmask
``(B, N)`` additive over the keys or None, pmult ``(N, N)`` multiplicative
after the softmax or None (neither has a gradient). It returns ``(B, N, C)``
in q's dtype (float32 or bfloat16 on the card). It rounds at the Pallas
kernel's points: the scale multiplies the fp32 scores, P is fp32, ``P·pmult``
is cast to q's dtype before ``·v``; the backward casts ``P·pmult`` before
``dv``, keeps ``dp`` and ``ds`` in fp32, casts ``ds`` before ``dq`` and ``dk``
and scales those after the product.

``window_core_bwd`` is the same recompute kernel as skinjax's
``_bwd_core`` runs it under K7's padded-window entry (``window_attention.py``
``_bwd_call``): B counts windows, window b adds the mask plane ``mask[b %
n_win]`` to its scores, and it also returns ``of = round(P)·v``, which the
padded entry's projection gradient reads. A bias gradient is summed over
groups of windows and then over the groups in order (``bias_groups``), so
that Swin-tiny's 4096 windows at stage 0 fill the card with no atomics.

Launches. The forward is one launch. In bf16 it runs on the tensor cores
(``mma.sync``): a block per (64 query rows, head, batch), a warp's q rows in
registers, K, V and the bias, kmask and pmult tiles streamed by ``cp.async``,
two passes over the keys (the online max and sum, then P, written fp32 when
asked, and o += round(P·pmult)·V), the scores and the softmax in the
recompute backward's code and order, so its P is the recompute backward's.
A bias at N not a multiple of 4 (197 at 224×224) is handed to it with its
rows padded to a multiple of 4 floats (``fwd_bias``), so that its tiles
stream by 16-byte copies. What bounds it
is its instructions more than its bytes (P's 79.5 MB of BEiT-large's ~134
MB); ``PERF.md`` has the numbers. The kernel takes 32 or 64 channels a
head, zero-padded (by the head width, in C). In fp32 it runs a CUDA-core
kernel of fp32 FMAs (the 1e-4 checks; TF32 would not hold them).

The backward's route. When a gradient will be asked for and the stored-P
residual of the call (``B·h·N²·4`` bytes) is at most ``STORE_P_MAX_BYTES``
(skinjax's 256 MB, ``_store_p_ok``), the forward keeps P and the stored-P
backward reads it. Above it the forward keeps no P, and the recompute
backward recomputes the softmax from q, k, v, the bias and the masks, as
skinjax's ``_ac_bwd`` does there. That constant is the port's one rule:
skinjax's other recompute triggers are TPU workarounds that the port does
not carry over (the Mosaic block cap ``4·hg·Np² > 4 MB`` and
``SKINJAX_REMAT``; ROADMAP.md, "Leave out of the port").

The stored-P backward's scratch depends on the dtype (``bwd_scratch_shapes``):
the fp32 kernels pass ds, a plane the size of P, from one launch to the next
and sum it over the batch for the bias gradient; the bf16 kernels keep ds in
registers, pass one statistic a query row, rowsum(dp·P), and sum a bias
gradient over groups of batches (``stored_p_groups``), each into a plane, and
then over the groups in order.

``attention_core_plain``, ``attention_core_bwd_plain`` and
``attention_core_bwd_recompute_plain`` and ``window_core_bwd_plain`` are the
plain PyTorch twins,
rounding at the same points; ``attention_core_reference`` is a copy of
skinjax's einsum reference. The wrappers dispatch on the device of q: a CPU
tensor goes to the twin, a CUDA tensor launches the kernel or raises. There
is no fallback from a failed build or launch. ``LAUNCHES`` counts calls that
launched a kernel (one per forward, one per backward; a twin call is not
counted).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from skinjax_torch.ops import acc_dtype, check_tensor

LAUNCHES: Dict[str, int] = {"global_attention_fwd": 0, "global_attention_bwd": 0,
                            "global_attention_bwd_recompute": 0}

MAX_TOKENS = 1024
MAX_HEAD_DIM = 64
# skinjax's ceiling for the stored-P residual (_STORE_P_DEFAULT_MAX_MB)
STORE_P_MAX_BYTES = 256 * 1024 * 1024
# blocks the recompute backward's key-column launch aims at when it sums a
# bias gradient in groups of windows (about eight waves of the H100's 132 SMs)
BIAS_GROUP_BLOCKS = 1056
# blocks the bf16 stored-P backward's key-column launch aims at when it sums
# a bias gradient in groups of batches: one wave of the H100's 132 SMs at its
# two blocks an SM (more groups add plane traffic and the planes' sum)
STORED_P_GROUP_BLOCKS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "skinjax_global_attention_error_string": ([_I], ctypes.c_char_p),
    "skinjax_global_attention_fwd": (
        [_I, _P, _P, _P, _L, _P, _I] + [_P] * 4 + [_I] * 4 + [_F, _P], _I),
    "skinjax_global_attention_bwd": ([_I, _P, _P, _P, _L] + [_P] * 9 + [_I] * 5 + [_F, _P], _I),
    "skinjax_global_attention_bwd_recompute": (
        [_I, _P, _P, _P, _L] + [_P] * 5 + [_I] + [_P] * 7 + [_I] * 5 + [_F, _P], _I),
}
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library():
    """The kernels' shared library, built with nvcc on first use (raises if
    the build fails)."""
    from skinjax_torch.ops import build

    return build.load("global_attention", _SIGNATURES)


def attention_core_reference(q, k, v, num_heads, bias=None, kmask=None, pmult=None):
    """skinjax's einsum reference: it scales q in the input dtype before the
    fp32 scores. Returns (B, N, C) in q's dtype."""
    B, N, C = q.shape
    h = num_heads
    hd = C // h
    acc = acc_dtype(q.dtype)
    with torch.autocast(q.device.type, enabled=False):
        qh, kh, vh = (t.reshape(B, N, h, hd) for t in (q, k, v))
        s = torch.einsum("bnhd,bmhd->bhnm", (qh * hd ** -0.5).to(acc), kh.to(acc))
        if bias is not None:
            s = s + bias[None].to(acc)
        if kmask is not None:
            s = s + kmask[:, None, None, :].to(acc)
        p = torch.softmax(s, dim=-1)
        if pmult is not None:
            p = p * pmult[None, None].to(acc)
        p = p.to(q.dtype)
        return torch.einsum("bhnm,bmhd->bnhd", p, vh).reshape(B, N, C)


# ---------------------------------------------------------------------------
# plain twins (the reference for the kernels, and the CPU path)
# ---------------------------------------------------------------------------


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, N, C) head-major → (B, h, N, hd)."""
    B, N, C = t.shape
    return t.reshape(B, N, h, C // h).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, h, N, hd) → (B, N, h·hd)."""
    B, h, N, hd = t.shape
    return t.transpose(1, 2).reshape(B, N, h * hd)


def attention_core_plain(q, k, v, bias, kmask, pmult, num_heads, mask=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic in PyTorch ops → (o (B, N, C) in q's
    dtype, P (B, h, N, N) fp32, before pmult); ``mask`` (n_win, N, N) adds
    plane b % n_win to batch b's scores, after the bias."""
    dt, acc = q.dtype, acc_dtype(q.dtype)
    scale = (q.shape[-1] // num_heads) ** -0.5
    with torch.autocast(q.device.type, enabled=False):
        qh, kh, vh = (_heads(t, num_heads).to(acc) for t in (q, k, v))
        s = (qh @ kh.transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias.to(acc)[None]
        if mask is not None:
            B, h, N, _ = s.shape
            nw = mask.shape[0]
            s = (s.reshape(B // nw, nw, h, N, N) + mask.to(acc)[None, :, None]).reshape(B, h, N, N)
        if kmask is not None:
            s = s + kmask.to(acc)[:, None, None, :]
        p = torch.softmax(s, dim=-1)
        pm = p * pmult.to(acc) if pmult is not None else p
        o = (pm.to(dt).to(acc) @ vh).to(dt)
        return _merge(o), p


def attention_core_bwd_plain(q, k, v, do, p, pmult, num_heads, has_bias
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                        Optional[torch.Tensor]]:
    """The backward kernel's arithmetic → (dq, dk, dv (B, N, C) in q's dtype,
    dbias (h, N, N) fp32 or None), what skinjax's ``_bwd_p_core`` returns."""
    dt, acc = q.dtype, acc_dtype(q.dtype)
    scale = (q.shape[-1] // num_heads) ** -0.5
    with torch.autocast(q.device.type, enabled=False):
        qh, kh, vh, doh = (_heads(t, num_heads).to(acc) for t in (q, k, v, do))
        p = p.to(acc)
        mlt = pmult.to(acc) if pmult is not None else None
        pb = (p * mlt if mlt is not None else p).to(dt).to(acc)
        dv = (pb.transpose(-1, -2) @ doh).to(dt)
        dp = doh @ vh.transpose(-1, -2)
        if mlt is not None:
            dp = dp * mlt
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dbias = ds.sum(0) if has_bias else None
        dsb = ds.to(dt).to(acc)
        dq = ((dsb @ kh) * scale).to(dt)
        dk = ((dsb.transpose(-1, -2) @ qh) * scale).to(dt)
        return _merge(dq), _merge(dk), _merge(dv), dbias


def attention_core_bwd_recompute_plain(q, k, v, do, bias, kmask, pmult, num_heads, has_bias
                                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                  Optional[torch.Tensor]]:
    """The recompute backward's arithmetic → (dq, dk, dv, dbias fp32 or
    None), what skinjax's ``_bwd_core`` returns for the global call (its
    ``of`` output left out): the forward's P recomputed, then the stored-P
    backward's rounding."""
    _, p = attention_core_plain(q, k, v, bias, kmask, pmult, num_heads)
    return attention_core_bwd_plain(q, k, v, do, p, pmult, num_heads, has_bias)


def window_core_bwd_plain(q, k, v, do, bias, mask, num_heads, has_bias):
    """The recompute backward's arithmetic with a window mask → (dq, dk, dv,
    of, dbias fp32 or None), what skinjax's ``_bwd_core`` returns."""
    of, p = attention_core_plain(q, k, v, bias, None, None, num_heads, mask)
    dq, dk, dv, dbias = attention_core_bwd_plain(q, k, v, do, p, None, num_heads, has_bias)
    return dq, dk, dv, of, dbias


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def admits(N: int, C: int, num_heads: int) -> bool:
    """Whether the kernels take N tokens of C channels in ``num_heads``
    heads: C divisible by the heads, at most ``MAX_HEAD_DIM`` channels a head
    and ``MAX_TOKENS`` tokens (the shapes ``_check`` refuses otherwise)."""
    return C % num_heads == 0 and C // num_heads <= MAX_HEAD_DIM and N <= MAX_TOKENS


def stores_p(q: torch.Tensor, num_heads: int) -> bool:
    """Whether the backward of this call reads a stored P: its residual
    ``B·h·N²·4`` bytes is at most ``STORE_P_MAX_BYTES``."""
    B, N, _ = q.shape
    return B * num_heads * N * N * 4 <= STORE_P_MAX_BYTES


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The row stride of a (B, N, C) tensor whose rows are evenly spaced with
    unit channel stride (contiguous, or a slice of a packed projection)."""
    B, N, _ = t.shape
    ld = t.stride(1)
    if t.stride(2) != 1 or (B > 1 and t.stride(0) != N * ld):
        return None
    return ld


def _check(q, k, v, bias, kmask, pmult, num_heads):
    """Shapes the kernels take. Returns (q, k, v, ld) with q, k, v sharing a
    row stride ld (made contiguous where they do not), and (bias, kmask,
    pmult) as contiguous fp32 or None."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"global attention takes {_DTYPES}; got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"q must be (B, N, C), got {tuple(q.shape)}")
    B, N, C = q.shape
    if not admits(N, C, num_heads):
        raise ValueError(f"the kernel takes C divisible by the heads, at most {MAX_HEAD_DIM} "
                         f"channels a head and {MAX_TOKENS} tokens; got C={C}, {num_heads} heads, "
                         f"N={N}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype}{tuple(t.shape)} on {t.device}; q is "
                             f"{q.dtype}{tuple(q.shape)} on {q.device}")
    ld = _row_stride(q)
    if ld is None or ld < C or any(_row_stride(t) != ld for t in (k, v)):
        q, k, v = (t.contiguous() for t in (q, k, v))
        ld = C
    extras = []
    for name, t, shape in (("bias", bias, (num_heads, N, N)), ("kmask", kmask, (B, N)),
                           ("pmult", pmult, (N, N))):
        if t is not None:
            t = t.float().contiguous()
            check_tensor(name, t, shape, torch.float32, q.device)
        extras.append(t)
    return (q, k, v, ld, *extras)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.skinjax_global_attention_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def fwd_bias(bias: Optional[torch.Tensor], dtype: torch.dtype
             ) -> Tuple[Optional[torch.Tensor], int]:
    """The bias (h, N, N) fp32 as the forward kernel reads it, and its row
    stride: for bfloat16 at N not a multiple of 4 (197 at 224×224), a copy
    with rows padded by zeros to a multiple of 4 floats, so that they start
    16-byte aligned and the kernel streams the bias's (64 × 64) tiles by
    16-byte copies (2.5 MB at BEiT-large); else the bias as it is."""
    if bias is None:
        return None, 0
    N = bias.shape[-1]
    if dtype != torch.bfloat16 or N % 4 == 0:
        return bias, N
    return F.pad(bias, (0, -N % 4)), N + -N % 4


def global_attention_fwd(q, k, v, bias, kmask, pmult, num_heads: int, emit_p: bool
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(o (B, N, C), P (B, h, N, N) fp32 when ``emit_p``, else None) from the
    forward kernel (CUDA) or its twin (CPU)."""
    if q.device.type == "cpu":
        o, p = attention_core_plain(q, k, v, bias, kmask, pmult, num_heads)
        return o, (p if emit_p else None)
    if q.device.type != "cuda":
        raise ValueError(f"global attention takes CPU or CUDA tensors, got {q.device}")
    q, k, v, ld, bias, kmask, pmult = _check(q, k, v, bias, kmask, pmult, num_heads)
    B, N, C = q.shape
    o = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    p = (torch.empty((B, num_heads, N, N), dtype=torch.float32, device=q.device) if emit_p
         else None)
    if q.numel() == 0:
        return o, p
    bias, bias_ld = fwd_bias(bias, q.dtype)
    lib = library()
    err = lib.skinjax_global_attention_fwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, _ptr(bias),
        bias_ld, _ptr(kmask), _ptr(pmult), o.data_ptr(), _ptr(p), B, N, C, num_heads,
        (C // num_heads) ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, err, "global_attention_fwd")
    LAUNCHES["global_attention_fwd"] += 1
    return o, p


def global_attention_bwd(q, k, v, do, p, pmult, num_heads: int, has_bias: bool):
    """(dq, dk, dv, dbias fp32 or None) from the backward kernel (CUDA) or
    its twin (CPU); ``p`` is the forward's P."""
    if q.device.type == "cpu":
        return attention_core_bwd_plain(q, k, v, do, p, pmult, num_heads, has_bias)
    if q.device.type != "cuda":
        raise ValueError(f"global attention takes CPU or CUDA tensors, got {q.device}")
    q, k, v, ld, _, _, pmult = _check(q, k, v, None, None, pmult, num_heads)
    B, N, C = q.shape
    check_tensor("do", do, (B, N, C), q.dtype, q.device)
    check_tensor("p", p, (B, num_heads, N, N), torch.float32, q.device)
    empty = lambda *shape, dt=q.dtype: torch.empty(shape, dtype=dt, device=q.device)  # noqa: E731
    dq, dk, dv = (empty(B, N, C) for _ in range(3))
    dbias = empty(num_heads, N, N, dt=torch.float32) if has_bias else None
    if q.numel() == 0:
        return dq, dk, dv, None if dbias is None else dbias.zero_()
    scratch_shape, partial_shape = bwd_scratch_shapes(q.dtype, B, N, num_heads, has_bias)
    scratch = empty(*scratch_shape, dt=torch.float32)
    partial = None if partial_shape is None else empty(*partial_shape, dt=torch.float32)
    groups = 1 if partial_shape is None else partial_shape[0]
    lib = library()
    err = lib.skinjax_global_attention_bwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), ld,
        do.data_ptr(), p.data_ptr(), _ptr(pmult), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch.data_ptr(), _ptr(dbias), _ptr(partial), groups, B, N, C, num_heads,
        (C // num_heads) ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, err, "global_attention_bwd")
    LAUNCHES["global_attention_bwd"] += 1
    return dq, dk, dv, dbias


def stored_p_groups(B: int, N: int, num_heads: int) -> int:
    """The groups of consecutive batches over which the bf16 stored-P
    backward sums a bias gradient, each into its own (h, Np, Np) fp32 plane
    (Np = N rounded up to the kernel's 64-key tiles) before the planes are
    added in order: enough that its key-column launch has about
    ``STORED_P_GROUP_BLOCKS`` blocks of 64 keys a head, at most B, and no
    more than keep the planes within ``STORE_P_MAX_BYTES`` (at least one).
    At BEiT-large (B=32, N=197, 16 heads) 4 groups of 8 batches: 16.8 MB of
    planes, where the ds plane of the float32 kernels is 79.5 MB."""
    tiles = -(-N // 64)
    plane = num_heads * (64 * tiles) ** 2 * 4
    fit = max(1, STORE_P_MAX_BYTES // plane)
    return max(1, min(B, fit, -(-STORED_P_GROUP_BLOCKS // (tiles * num_heads))))


def bwd_scratch_shapes(dtype: torch.dtype, B: int, N: int, num_heads: int, has_bias: bool):
    """The fp32 scratch the stored-P backward kernel takes → (its shape, the
    shape of the bias gradient's group planes or None). float32: ds, a plane
    the size of P, which its CUDA-core launches pass on and sum over the
    batch. bfloat16: the row statistic rowsum(dp·P), one value a query row
    (its tensor-core kernels keep ds in registers), and, with a bias
    gradient, the planes of the groups the kernel forms (ceil(B / groups)
    batches each, ``stored_p_groups``), in tiles of 64 × 64."""
    if dtype == torch.float32:
        return (B, num_heads, N, N), None
    if not has_bias:
        return (B, num_heads, N), None
    groups = -(-B // -(-B // stored_p_groups(B, N, num_heads)))
    Np = 64 * -(-N // 64)
    return (B, num_heads, N), (groups, num_heads, Np, Np)


def bias_groups(B: int, N: int, num_heads: int) -> int:
    """The groups of consecutive batches (windows) over which the recompute
    backward sums a bias gradient, each into an (h, N, N) fp32 plane before
    the planes are added in order: enough that the key-column launch has
    about ``BIAS_GROUP_BLOCKS`` blocks of 32 keys a head, at most B. Their
    scratch, groups·h·N²·4 bytes, is at most 1056·32·4·N bytes (138 MB at
    ``MAX_TOKENS``), within the stored-P limit (5.3 MB at Swin-tiny's stage
    0: 176 planes of 3 × 49²)."""
    return max(1, min(B, -(-BIAS_GROUP_BLOCKS // (-(-N // 32) * num_heads))))


def _bwd_recompute(q, k, v, do, bias, kmask, pmult, mask, num_heads, has_bias, emit_of):
    """The recompute backward kernel → (dq, dk, dv, of or None, dbias or None)."""
    q, k, v, ld, bias, kmask, pmult = _check(q, k, v, bias, kmask, pmult, num_heads)
    B, N, C = q.shape
    check_tensor("do", do, (B, N, C), q.dtype, q.device)
    if has_bias and bias is None:
        raise ValueError("a bias gradient needs the bias")
    if mask is not None:
        mask = mask.float().contiguous()
        if mask.dim() != 3 or B % mask.shape[0]:
            raise ValueError(f"mask must be (n_win, {N}, {N}) with n_win dividing {B}; got "
                             f"{tuple(mask.shape)}")
        check_tensor("mask", mask, (mask.shape[0], N, N), torch.float32, q.device)
    empty = lambda *shape, dt=q.dtype: torch.empty(shape, dtype=dt, device=q.device)  # noqa: E731
    dq, dk, dv = (empty(B, N, C) for _ in range(3))
    of = empty(B, N, C) if emit_of else None
    stats = empty(3, B, num_heads, N, dt=torch.float32)
    dbias = empty(num_heads, N, N, dt=torch.float32) if has_bias else None
    if q.numel() == 0:
        return dq, dk, dv, of, None if dbias is None else dbias.zero_()
    groups = bias_groups(B, N, num_heads) if has_bias else 1
    partial = empty(groups, num_heads, N, N, dt=torch.float32) if groups > 1 else None
    lib = library()
    err = lib.skinjax_global_attention_bwd_recompute(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), ld,
        do.data_ptr(), _ptr(bias), _ptr(kmask), _ptr(pmult), _ptr(mask),
        1 if mask is None else mask.shape[0], dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(of), stats.data_ptr(), _ptr(dbias), _ptr(partial), groups, B, N, C, num_heads,
        (C // num_heads) ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise(lib, err, "global_attention_bwd_recompute")
    LAUNCHES["global_attention_bwd_recompute"] += 1
    return dq, dk, dv, of, dbias


def global_attention_bwd_recompute(q, k, v, do, bias, kmask, pmult, num_heads: int,
                                   has_bias: bool):
    """(dq, dk, dv, dbias fp32 or None) from the recompute backward kernel
    (CUDA) or its twin (CPU), from the forward's inputs: no P."""
    if q.device.type == "cpu":
        return attention_core_bwd_recompute_plain(q, k, v, do, bias, kmask, pmult, num_heads,
                                                  has_bias)
    if q.device.type != "cuda":
        raise ValueError(f"global attention takes CPU or CUDA tensors, got {q.device}")
    dq, dk, dv, _, dbias = _bwd_recompute(q, k, v, do, bias, kmask, pmult, None, num_heads,
                                          has_bias, False)
    return dq, dk, dv, dbias


def window_core_bwd(q, k, v, do, bias, mask, num_heads: int, has_bias: bool):
    """(dq, dk, dv, of, dbias fp32 or None) from the recompute backward kernel
    (CUDA) or its twin (CPU) on B windows, window b with the mask plane
    ``mask[b % n_win]`` (``mask`` (n_win, N, N) or None): skinjax's
    ``_bwd_core`` with its window mask."""
    if q.device.type == "cpu":
        return window_core_bwd_plain(q, k, v, do, bias, mask, num_heads, has_bias)
    if q.device.type != "cuda":
        raise ValueError(f"global attention takes CPU or CUDA tensors, got {q.device}")
    return _bwd_recompute(q, k, v, do, bias, None, None, mask, num_heads, has_bias, True)


class _AttentionCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, kmask, pmult, num_heads, needs_grad):
        emit_p = needs_grad and stores_p(q, num_heads)
        o, p = global_attention_fwd(q, k, v, bias, kmask, pmult, num_heads, emit_p)
        if needs_grad:  # P, or what recomputes it
            ctx.save_for_backward(q, k, v, p, pmult, *((None, None) if emit_p else (bias, kmask)))
        ctx.num_heads = num_heads
        ctx.bias_dtype = None if bias is None else bias.dtype
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, p, pmult, bias, kmask = ctx.saved_tensors
        need = ctx.needs_input_grad
        has_bias = ctx.bias_dtype is not None and need[3]
        with torch.autocast(q.device.type, enabled=False):
            do = do.to(q.dtype).contiguous()
            if p is not None:
                dq, dk, dv, dbias = global_attention_bwd(q, k, v, do, p, pmult, ctx.num_heads,
                                                         has_bias)
            else:
                dq, dk, dv, dbias = global_attention_bwd_recompute(
                    q, k, v, do, bias, kmask, pmult, ctx.num_heads, has_bias)
        return (dq if need[0] else None, dk if need[1] else None, dv if need[2] else None,
                None if dbias is None else dbias.to(ctx.bias_dtype), None, None, None, None)


def attention_core(q, k, v, bias, kmask, pmult, num_heads: int) -> torch.Tensor:
    """Global MHA core on head-major (B, N, C) q, k, v; differentiable in q,
    k, v and the bias. Where grad mode is on and an input needs a gradient,
    the forward keeps P for the backward at or below ``STORE_P_MAX_BYTES``
    and what recomputes it above."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias))
    return _AttentionCore.apply(q, k, v, bias, kmask, pmult, num_heads, needs_grad)
