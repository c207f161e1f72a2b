"""Window multi-head attention as hand-written CUDA kernels: on an NHWC map
(forward and backward), and on windows already partitioned (forward; its
backward is K12's recompute core with the window mask).

Counterpart of ``skinjax/ops/pallas/window_attention.py``'s strip-blocked
entry ``window_attention_nhwc`` and padded-window entry ``window_attention``
(K7): per window of ``window × window`` tokens, qkv projection → per-head
scores (+ relative-position bias, + a per-window additive mask) → softmax →
·V → head merge → output projection.

  kernel                     CUDA entry point (csrc/window_attention.cu)  replaces (Pallas TPU kernel)
  window_attention_fwd       skinjax_window_attention_fwd                 window_attention.py _strip_fwd
  window_attention_bwd       skinjax_window_attention_bwd                 window_attention.py _strip_bwd
  window_attention_pad_fwd   skinjax_window_attention_pad_fwd             window_attention.py _fwd

``window_attention_nhwc`` is a ``torch.autograd.Function`` with the JAX
signature and layouts: x ``(B, H, W, C)``, wqkv ``(C, 3C)``, bqkv ``(3C,)``,
wproj ``(C, C)``, bproj ``(C,)``, bias ``(h, N, N)`` or None, mask
``(nH·nW, N, N)`` or None (window ``(i, j)`` of every image adds
``mask[i·nW + j]``; no gradient), N = window². x and the weights share one
dtype (float32 or bfloat16); bias and mask are read as float32. It rounds at
the Pallas kernel's points: qkv to the input dtype after the fp32 sum and
bias; the scale on the fp32 scores; an fp32 softmax; p to the input dtype
before p·v; ``of`` before the projection; y once. The backward kernel
recomputes qkv, ``do = dy·wprojᵀ`` and the softmax and emits ``(dqkv, of,
dbias)`` in NHWC, as ``_strip_bwd`` does; dx and the weight gradients are flat
matrix products here (``_wa_nhwc_bwd``).

Launches. The forward: a core launch (a block per window and head) and a
projection launch. The backward: one core launch, a block per window and head
(with a bias gradient, per window group and head, ``bwd_blocks``), then, with
a bias, one launch that adds the groups' partial dbias planes in order (no
atomics). The bf16 kernels run every product on the tensor cores
(``mma.sync``): the head's q, k, v (and the backward's do) projections from x
(and dy) rows gathered by token offset (16-byte ``cp.async``), the scores,
the fp32 softmax and ``of`` in registers, in one device function that the
forward and backward cores share, so that the forward's ``of`` is the
backward's bit for bit (``return_of=True`` hands it back); the backward goes
on to dp and ds in registers and to round(P) and round(ds·scale) through two
bf16 tiles for dv and dk; the forward's projection is a tiled product, the
bias added before the one cast. What bounds them is their instructions and
the re-reads of x, dy (once a head) and the head's weight slices (once a
window), not their ~77 and ~231 MB at DaViT's stage 1. The fp32 kernels run
fp32 FMAs on the CUDA cores (the 1e-4 checks; TF32 would not hold them).

``window_attention_nhwc_plain`` and ``window_attention_nhwc_bwd_plain`` are
the plain PyTorch twins, rounding at the same points. The wrappers dispatch
on the device of x: a CPU tensor goes to the twin, a CUDA tensor launches the
kernel or raises. There is no fallback from a failed build or launch.

``window_attention(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads)`` is
the padded entry: x ``(nB, N, C)`` windows (``window_partition``'s layout),
bias ``(h, N, N)`` or None, mask ``(nW, N, N)`` or None, window j adding
``mask[j % nW]``. Its forward is the NHWC forward's code with the other
address map (no copies around the call, and none of skinjax's pad of N to a
multiple of 16 with -1e9 keys, a Mosaic workaround); its backward follows
``_bwd_call``: ``do = dy·wprojᵀ`` and the recomputed qkv by matrix products
rounded to the dtype, the core by ``global_attention.window_core_bwd`` (the
recompute kernel with the window mask, which also returns ``of``), then dW,
db and dx by matrix products and sums. ``window_attention_pad_plain`` is the
forward's twin.

``LAUNCHES`` counts calls that launched a kernel (one per forward, one per
backward; a twin call is not counted; the padded entry's backward counts in
``global_attention.LAUNCHES``). The module also keeps its own copies
of ``window_partition``/``window_reverse`` (skinjax
``models/backbones/transformer_zoo.py``) and of the einsum reference
``window_attention_reference``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from skinjax_torch.ops import check_tensor

LAUNCHES: Dict[str, int] = {"window_attention_fwd": 0, "window_attention_bwd": 0,
                            "window_attention_pad_fwd": 0}

MAX_TOKENS = 64  # window <= 8
MAX_HEAD_DIM = 32
# window blocks of the backward when a bias gradient is summed: each block
# adds its windows' dbias into one partial, and a second pass adds the partials
BIAS_BLOCKS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "skinjax_window_attention_error_string": ([_I], ctypes.c_char_p),
    "skinjax_window_attention_fwd": ([_I] + [_P] * 9 + [_I] * 6 + [_F, _P], _I),
    "skinjax_window_attention_bwd": ([_I] + [_P] * 11 + [_I] * 7 + [_F, _P], _I),
    "skinjax_window_attention_pad_fwd": ([_I] + [_P] * 9 + [_I] * 5 + [_F, _P], _I),
}
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library():
    """The kernels' shared library, built with nvcc on first use (raises if
    the build fails)."""
    from skinjax_torch.ops import build

    return build.load("window_attention", _SIGNATURES)


# ---------------------------------------------------------------------------
# windows (copies of skinjax's transformer_zoo helpers) and the reference
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nH·nW, w·w, C); H, W divisible by w."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * (H // w) * (W // w), w * w, C)


def window_reverse(x: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    B = x.shape[0] // ((H // w) * (W // w))
    x = x.reshape(B, H // w, W // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def window_attention_reference(x, wqkv, bqkv, wproj, bproj, num_heads, bias=None, mask=None):
    """The einsum reference on partitioned windows: x (nB, N, C); bias
    (h, N, N) additive; mask (nW, N, N) additive. It scales q in the input
    dtype before the fp32 scores, as skinjax's reference does."""
    nB, N, C = x.shape
    h = num_heads
    hd = C // h
    with torch.autocast(x.device.type, enabled=False):
        qkv = x @ wqkv.to(x.dtype) + bqkv.to(x.dtype)
        q = qkv[..., :C].reshape(nB, N, h, hd)
        k = qkv[..., C:2 * C].reshape(nB, N, h, hd)
        v = qkv[..., 2 * C:].reshape(nB, N, h, hd)
        attn = torch.einsum("bnhd,bmhd->bhnm", (q * hd ** -0.5).float(), k.float())
        if bias is not None:
            attn = attn + bias[None].float()
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(nB // nW, nW, h, N, N) + mask[None, :, None].float()).reshape(
                nB, h, N, N)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(nB, N, C)
        return out @ wproj.to(x.dtype) + bproj.to(x.dtype)


# ---------------------------------------------------------------------------
# plain twins (the reference for the kernels, and the CPU path)
# ---------------------------------------------------------------------------


def _rmm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a·b summed in fp32, rounded once to ``dtype``."""
    return (a.float() @ b.float()).to(dtype)


def _windows_qkv(x, wqkv, bqkv, num_heads, window):
    """Per-window, per-head q, k, v (nB, h, N, hd), rounded to x's dtype."""
    dt = x.dtype
    C = x.shape[-1]
    h, hd = num_heads, C // num_heads
    xw = window_partition(x, window)
    nB, N, _ = xw.shape
    qkv = (xw.float() @ wqkv.float() + bqkv.float()).to(dt)
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(nB, N, h, hd).transpose(1, 2)
               for i in range(3))
    return q, k, v


def _probs(q, k, bias, mask, scale):
    """The fp32 softmax of (q·kᵀ)·scale + bias + mask, (nB, h, N, N)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()[None]
    if mask is not None:
        nB, h, N, _ = s.shape
        nW = mask.shape[0]
        s = (s.reshape(nB // nW, nW, h, N, N) + mask.float()[None, :, None]).reshape(nB, h, N, N)
    return torch.softmax(s, dim=-1)


def _merge(t, H, W, window):
    """(nB, h, N, hd) per head → (B, H, W, h·hd) NHWC."""
    nB, h, N, hd = t.shape
    return window_reverse(t.transpose(1, 2).reshape(nB, N, h * hd), window, H, W)


def window_attention_nhwc_plain(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads, window,
                                return_of=False):
    """The forward kernel's arithmetic in PyTorch ops → y (B, H, W, C), and
    with ``return_of`` (y, of): of (B, H, W, C) is the heads' p·v before the
    projection, what the backward twin also returns."""
    B, H, W, C = x.shape
    dt = x.dtype
    with torch.autocast(x.device.type, enabled=False):
        q, k, v = _windows_qkv(x, wqkv, bqkv, num_heads, window)
        p = _probs(q, k, bias, mask, (C // num_heads) ** -0.5).to(dt)
        of = _merge(_rmm(p, v, dt), H, W, window)
        y = (of.reshape(-1, C).float() @ wproj.float() + bproj.float()).to(dt).reshape(
            B, H, W, C)
        return (y, of) if return_of else y


def window_attention_pad_plain(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads,
                               return_of=False):
    """The padded entry's forward arithmetic on windows x (nB, N, C) → y (nB,
    N, C): the NHWC forward's, on windows already partitioned; with
    ``return_of`` (y, of), of (nB, N, C)."""
    nB, N, C = x.shape
    dt = x.dtype
    h, hd = num_heads, C // num_heads
    with torch.autocast(x.device.type, enabled=False):
        qkv = (x.float() @ wqkv.float() + bqkv.float()).to(dt)
        q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(nB, N, h, hd).transpose(1, 2)
                   for i in range(3))
        p = _probs(q, k, bias, mask, hd ** -0.5).to(dt)
        of = _rmm(p, v, dt).transpose(1, 2).reshape(nB, N, C)
        y = (of.float() @ wproj.float() + bproj.float()).to(dt)
        return (y, of) if return_of else y


def window_attention_nhwc_bwd_plain(x, dy, wqkv, bqkv, wproj, bias, mask, num_heads, window
                                    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The backward kernel's arithmetic → (dqkv (B, H, W, 3C), of (B, H, W, C),
    dbias (h, N, N) fp32 or None), what skinjax's ``_strip_bwd`` returns."""
    B, H, W, C = x.shape
    dt = x.dtype
    h, hd = num_heads, C // num_heads
    scale = hd ** -0.5
    with torch.autocast(x.device.type, enabled=False):
        q, k, v = _windows_qkv(x, wqkv, bqkv, num_heads, window)
        do = window_partition(_rmm(dy.reshape(-1, C), wproj.t(), dt).reshape(B, H, W, C), window)
        nB, N, _ = do.shape
        do = do.reshape(nB, N, h, hd).transpose(1, 2)
        p = _probs(q, k, bias, mask, scale)  # fp32
        pb = p.to(dt)
        of = _rmm(pb, v, dt)
        dv = _rmm(pb.transpose(-1, -2), do, dt)
        dp = do.float() @ v.float().transpose(-1, -2)
        dsp = p * (dp - (dp * p).sum(-1, keepdim=True))
        dbias = dsp.sum(0) if bias is not None else None
        ds = (dsp * scale).to(dt)
        dq = _rmm(ds, k, dt)
        dk = _rmm(ds.transpose(-1, -2), q, dt)
        dqkv = torch.cat([_merge(t, H, W, window) for t in (dq, dk, dv)], dim=-1)
        return dqkv, _merge(of, H, W, window), dbias


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_weights(x, wqkv, bqkv, wproj, bproj, bias, num_heads, N):
    """What both entries take of x's dtype and channels, the weights and the
    bias (N tokens a window); returns the bias as contiguous fp32 or None."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"window attention takes {_DTYPES}; got {x.dtype}")
    C = x.shape[-1]
    if C % num_heads or C // num_heads > MAX_HEAD_DIM or N > MAX_TOKENS:
        raise ValueError(f"the kernel takes C divisible by the heads, at most {MAX_HEAD_DIM} "
                         f"channels a head and {MAX_TOKENS} tokens a window; got C={C}, "
                         f"{num_heads} heads, {N} tokens")
    check_tensor("x", x, tuple(x.shape), x.dtype, x.device)
    check_tensor("wqkv", wqkv, (C, 3 * C), x.dtype, x.device)
    check_tensor("bqkv", bqkv, (3 * C,), x.dtype, x.device)
    check_tensor("wproj", wproj, (C, C), x.dtype, x.device)
    if bproj is not None:
        check_tensor("bproj", bproj, (C,), x.dtype, x.device)
    if bias is not None:
        bias = bias.float().contiguous()
        check_tensor("bias", bias, (num_heads, N, N), torch.float32, x.device)
    return bias


def _check(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads, window):
    """Shapes the NHWC kernels take; returns (bias, mask) as contiguous fp32
    or None."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    _, H, W, _ = x.shape
    N = window * window
    bias = _check_weights(x, wqkv, bqkv, wproj, bproj, bias, num_heads, N)
    if mask is not None:
        mask = mask.float().contiguous()
        check_tensor("mask", mask, ((H // window) * (W // window), N, N), torch.float32,
                     x.device)
    return bias, mask


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.skinjax_window_attention_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def _check_pad(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads):
    """Shapes the padded forward takes; returns (bias, mask) as contiguous
    fp32 or None."""
    if x.dim() != 3:
        raise ValueError(f"x must be (nB, N, C) windows, got {tuple(x.shape)}")
    nB, N, _ = x.shape
    bias = _check_weights(x, wqkv, bqkv, wproj, bproj, bias, num_heads, N)
    if mask is not None:
        mask = mask.float().contiguous()
        if mask.dim() != 3 or nB % mask.shape[0]:
            raise ValueError(f"mask must be (nW, {N}, {N}) with nW dividing {nB}; got "
                             f"{tuple(mask.shape)}")
        check_tensor("mask", mask, (mask.shape[0], N, N), torch.float32, x.device)
    return bias, mask


def window_attention_pad_fwd(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads,
                             return_of=False):
    """y (nB, N, C) of the padded entry from its forward kernels (CUDA) or its
    twin (CPU); with ``return_of`` (y, of), of (nB, N, C) the core's output
    before the projection (the kernels write it in any case)."""
    if x.device.type == "cpu":
        return window_attention_pad_plain(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads,
                                          return_of)
    if x.device.type != "cuda":
        raise ValueError(f"window attention takes CPU or CUDA tensors, got {x.device}")
    bias, mask = _check_pad(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads)
    nB, N, C = x.shape
    of, y = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return (y, of) if return_of else y
    lib = library()
    err = lib.skinjax_window_attention_pad_fwd(
        int(x.dtype == torch.bfloat16), x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
        wproj.data_ptr(), bproj.data_ptr(), None if bias is None else bias.data_ptr(),
        None if mask is None else mask.data_ptr(), of.data_ptr(), y.data_ptr(), nB, N, C,
        num_heads, 1 if mask is None else mask.shape[0], (C // num_heads) ** -0.5,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, err, "window_attention_pad_fwd")
    LAUNCHES["window_attention_pad_fwd"] += 1
    return (y, of) if return_of else y


def window_attention_fwd(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads, window,
                         return_of=False):
    """y (B, H, W, C) from the NHWC forward kernels (CUDA) or their twin
    (CPU); with ``return_of`` (y, of), of (B, H, W, C) the core's output
    before the projection, which the backward also emits."""
    if x.device.type == "cpu":
        return window_attention_nhwc_plain(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads,
                                           window, return_of)
    if x.device.type != "cuda":
        raise ValueError(f"window attention takes CPU or CUDA tensors, got {x.device}")
    bias, mask = _check(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads, window)
    B, H, W, C = x.shape
    of, y = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return (y, of) if return_of else y
    lib = library()
    err = lib.skinjax_window_attention_fwd(
        int(x.dtype == torch.bfloat16), x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
        wproj.data_ptr(), bproj.data_ptr(), None if bias is None else bias.data_ptr(),
        None if mask is None else mask.data_ptr(), of.data_ptr(), y.data_ptr(), B, H, W, C,
        num_heads, window, (C // num_heads) ** -0.5,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, err, "window_attention_fwd")
    LAUNCHES["window_attention_fwd"] += 1
    return (y, of) if return_of else y


def bwd_blocks(n_windows: int, has_bias: bool) -> int:
    """The window blocks of the backward kernel, each launched once a head:
    one a window; with a bias gradient at most ``BIAS_BLOCKS``, each summing
    the dbias of windows blk, blk + blocks, ... in order into its own
    (heads, N, N) partial plane, which a second launch adds in block order."""
    if not has_bias:
        return n_windows
    return max(1, min(n_windows, BIAS_BLOCKS))


def window_attention_bwd(x, dy, wqkv, bqkv, wproj, bias, mask, num_heads, window):
    """(dqkv, of, dbias) from the backward kernel (CUDA) or its twin (CPU)."""
    if x.device.type == "cpu":
        return window_attention_nhwc_bwd_plain(x, dy, wqkv, bqkv, wproj, bias, mask, num_heads,
                                               window)
    if x.device.type != "cuda":
        raise ValueError(f"window attention takes CPU or CUDA tensors, got {x.device}")
    bias, mask = _check(x, wqkv, bqkv, wproj, None, bias, mask, num_heads, window)
    check_tensor("dy", dy, tuple(x.shape), x.dtype, x.device)
    B, H, W, C = x.shape
    N = window * window
    dqkv = torch.empty((B, H, W, 3 * C), dtype=x.dtype, device=x.device)
    of = torch.empty_like(x)
    blocks = bwd_blocks(B * (H // window) * (W // window), bias is not None)
    partial, dbias = None, None
    if bias is not None:
        partial = torch.empty((blocks, num_heads, N, N), dtype=torch.float32, device=x.device)
        dbias = torch.empty((num_heads, N, N), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dqkv, of, None if dbias is None else dbias.zero_()
    lib = library()
    err = lib.skinjax_window_attention_bwd(
        int(x.dtype == torch.bfloat16), x.data_ptr(), dy.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wproj.data_ptr(), None if bias is None else bias.data_ptr(),
        None if mask is None else mask.data_ptr(), dqkv.data_ptr(), of.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if dbias is None else dbias.data_ptr(), blocks, B, H, W, C, num_heads, window,
        (C // num_heads) ** -0.5, torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, err, "window_attention_bwd")
    LAUNCHES["window_attention_bwd"] += 1
    return dqkv, of, dbias


def _mm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a·b with fp32 accumulation, rounded to ``dtype``: on the card cuBLAS
    sums bf16 products in fp32 (and fp32 ones in fp32: TF32 is off), so the
    product stays in the input dtype; on the CPU it is summed in fp32 here."""
    if a.device.type == "cuda":
        return (a @ b).to(dtype)
    return _rmm(a, b, dtype)


class _WindowAttentionNHWC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads, window):
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bias, mask)
        ctx.num_heads, ctx.window = num_heads, window
        return window_attention_fwd(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads, window)

    @staticmethod
    def backward(ctx, dy):
        x, wqkv, bqkv, wproj, bias, mask = ctx.saved_tensors
        B, H, W, C = x.shape
        with torch.autocast(x.device.type, enabled=False):
            dy = dy.to(x.dtype).contiguous()
            dqkv, of, dbias = window_attention_bwd(x, dy, wqkv, bqkv, wproj, bias, mask,
                                                   ctx.num_heads, ctx.window)
            xf, dyf = x.reshape(-1, C), dy.reshape(-1, C)
            dqkvf, off = dqkv.reshape(-1, 3 * C), of.reshape(-1, C)
            need = ctx.needs_input_grad
            dx = _mm(dqkvf, wqkv.t(), x.dtype).reshape(B, H, W, C) if need[0] else None
            dwqkv = _mm(xf.t(), dqkvf, wqkv.dtype) if need[1] else None
            dbqkv = dqkvf.float().sum(0).to(bqkv.dtype) if need[2] else None
            dwproj = _mm(off.t(), dyf, wproj.dtype) if need[3] else None
            dbproj = dyf.float().sum(0).to(wproj.dtype) if need[4] else None
            dbias = dbias.to(bias.dtype) if bias is not None and need[5] else None
        return dx, dwqkv, dbqkv, dwproj, dbproj, dbias, None, None, None


def window_attention_nhwc(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads: int,
                          window: int) -> torch.Tensor:
    """Window MHA on the NHWC map x (B, H, W, C), H and W multiples of
    ``window``; differentiable in x, the weights and the bias."""
    if x.dim() != 4 or x.shape[1] % window or x.shape[2] % window:
        raise ValueError(f"x must be (B, H, W, C) with H and W multiples of the window "
                         f"{window}; got {tuple(x.shape)}")
    return _WindowAttentionNHWC.apply(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads,
                                      window)


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads):
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bias, mask)
        ctx.num_heads = num_heads
        return window_attention_pad_fwd(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads)

    @staticmethod
    def backward(ctx, dy):
        from skinjax_torch.ops.global_attention import window_core_bwd

        x, wqkv, bqkv, wproj, bias, mask = ctx.saved_tensors
        nB, N, C = x.shape
        need = ctx.needs_input_grad
        with torch.autocast(x.device.type, enabled=False):
            dt = x.dtype
            dyf, xf = dy.to(dt).reshape(-1, C), x.reshape(-1, C)
            do = _mm(dyf, wproj.t(), dt).reshape(nB, N, C)
            qkv = (xf.float() @ wqkv.float() + bqkv.float()).to(dt).reshape(nB, N, 3 * C)
            dq, dk, dv, of, dbias = window_core_bwd(
                qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], do, bias, mask,
                ctx.num_heads, bias is not None and need[5])
            dqkvf = torch.cat([dq, dk, dv], dim=-1).reshape(-1, 3 * C)
            dx = _mm(dqkvf, wqkv.t(), dt).reshape(nB, N, C) if need[0] else None
            dwqkv = _mm(xf.t(), dqkvf, wqkv.dtype) if need[1] else None
            dbqkv = dqkvf.float().sum(0).to(bqkv.dtype) if need[2] else None
            dwproj = _mm(of.reshape(-1, C).t(), dyf, wproj.dtype) if need[3] else None
            dbproj = dyf.float().sum(0).to(wproj.dtype) if need[4] else None
            dbias = dbias.to(bias.dtype) if dbias is not None else None
        return dx, dwqkv, dbqkv, dwproj, dbproj, dbias, None, None


def window_attention(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads: int) -> torch.Tensor:
    """K7's padded-window entry: window MHA on x (nB, N, C) windows (bias (h,
    N, N) or None; mask (nW, N, N) or None, window j adding mask[j % nW]);
    differentiable in x, the weights and the bias."""
    return _WindowAttention.apply(x, wqkv, bqkv, wproj, bproj, bias, mask, num_heads)
