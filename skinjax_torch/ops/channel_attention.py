"""DaViT's channel multi-head attention, projections included, as a
hand-written CUDA kernel pair, forward and backward.

Counterpart of ``skinjax/ops/pallas/channel_attention.py`` (K8):

  kernel                   CUDA entry point (csrc/channel_attention.cu)  replaces (Pallas TPU kernel)
  channel_attention_fwd    skinjax_channel_attention_fwd                 channel_attention.py _ch_call (_ch_fwd_kernel)
  channel_attention_bwd    skinjax_channel_attention_bwd                 channel_attention.py _ch_call (_ch_bwd_kernel)

``channel_attention(x, wqkv, bqkv, wproj, bproj, num_heads)`` is a
``torch.autograd.Function`` with skinjax's signature and layouts: x ``(B, N,
C)``, wqkv ``(C, 3C)``, bqkv ``(3C,)``, wproj ``(C, C)``, bproj ``(C,)``, one
dtype (float32 or bfloat16). Per head (hd = C / num_heads channels) it
computes ``softmax((kᵀv)·scale)``, an ``(hd, hd)`` attention summed over all N
tokens, and ``out = q·pᵀ``, then the output projection. It rounds at the Pallas
kernel's points: q, k, v to the input dtype after the fp32 sum and bias; the
scale on the fp32 scores after the product (skinjax's reference and the
port's plain ``DaViTChannelAttention`` scale k in the input dtype instead); an
fp32 softmax; p to the input dtype before ``q·pᵀ``; ``out`` before the
projection; y once. The backward kernel recomputes q, k, v, ``do = dy·wprojᵀ``
and the softmax and emits ``(dqkv, of)``, as ``_ch_bwd_kernel`` does; dx and
the weight gradients are flat matrix products here, as in skinjax's
``_ca_bwd``.

skinjax's VMEM gate ``channel_attention_supported`` and ``SKINJAX_CHATTN_MAXN``
are TPU limits and are left out: every shape within ``MAX_HEAD_DIM`` goes
through the kernel.

``plan`` chooses the route of a CUDA call and says what it launches and
allocates; the wrapper passes the route to the kernels, which check its
shapes. bf16 at 32 channels a head with a head count that 3 divides
(DaViT's 3, 6, 12, 24) takes the tensor-core kernels: a block projects
``HEAD_GROUP`` heads from one read of each step of x (and dy), and the
forward fuses the output projection, so it allocates nothing in the input
dtype; the backward keeps q, k, v and do in four (B, N, C) planes between
its first and last launch. Every other shape, and fp32, takes the CUDA-core
kernels, whose
forward writes of to a (B, N, C) scratch and whose backward keeps q, k, v
and do in a (B, N, 4, C) one. Both routes take one fp32 scratch of (hd, hd)
planes: the segments' partial sums, pb (and ds).

``channel_attention_plain`` and ``channel_attention_bwd_plain`` are the plain
PyTorch twins, rounding at the same points; ``channel_attention_reference``
is a copy of skinjax's einsum reference. The wrappers dispatch on the device
of x: a CPU tensor goes to the twin, a CUDA tensor launches the kernel or
raises. There is no fallback from a failed build or launch. ``LAUNCHES``
counts calls that launched a kernel (one per forward, one per backward; a
twin call is not counted).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from skinjax_torch.ops import acc_dtype, check_tensor

LAUNCHES: Dict[str, int] = {"channel_attention_fwd": 0, "channel_attention_bwd": 0}

MAX_HEAD_DIM = 32
MMA_HEAD_DIM = 32  # the tensor-core route's channels a head (csrc kHd)
HEAD_GROUP = 3  # the heads a tensor-core block projects (csrc kG)
SEGMENT = 256  # tokens a block of the kernel's partial sums (csrc kSeg)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "skinjax_channel_attention_error_string": ([_I], ctypes.c_char_p),
    "skinjax_channel_attention_fwd": ([_I] * 2 + [_P] * 9 + [_I] * 5 + [_F, _P], _I),
    "skinjax_channel_attention_bwd": ([_I] * 2 + [_P] * 11 + [_I] * 5 + [_F, _P], _I),
}
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library():
    """The kernels' shared library, built with nvcc on first use (raises if
    the build fails)."""
    from skinjax_torch.ops import build

    return build.load("channel_attention", _SIGNATURES)


def channel_attention_reference(x, wqkv, bqkv, wproj, bproj, num_heads):
    """skinjax's einsum reference: k scaled in the input dtype before the
    fp32 scores, p rounded to the input dtype, ``p·q`` in the input dtype."""
    B, N, C = x.shape
    h = num_heads
    hd = C // h
    with torch.autocast(x.device.type, enabled=False):
        qkv = x @ wqkv + bqkv
        q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, h, hd) for i in range(3))
        acc = acc_dtype(x.dtype)
        attn = torch.einsum("bnhc,bnhd->bhcd", (k * hd ** -0.5).to(acc), v.to(acc))
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bhcd,bnhd->bnhc", attn, q).reshape(B, N, C)
        return out @ wproj + bproj


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


def _qkv(x, wqkv, bqkv, num_heads):
    """q, k, v (B, h, N, hd), each rounded to x's dtype after the fp32 sum."""
    acc = acc_dtype(x.dtype)
    qkv = (x.to(acc) @ wqkv.to(acc) + bqkv.to(acc)).to(x.dtype)
    C = x.shape[-1]
    return tuple(_heads(qkv[..., i * C:(i + 1) * C], num_heads) for i in range(3))


def _probs(k, v, scale):
    """The fp32 softmax of (kᵀv)·scale over each row, (B, h, hd, hd)."""
    acc = acc_dtype(k.dtype)
    return torch.softmax((k.to(acc).transpose(-1, -2) @ v.to(acc)) * scale, dim=-1)


def _rmm(a, b, dtype):
    """a·b summed in fp32 (fp64 for fp64), rounded once to ``dtype``."""
    acc = acc_dtype(dtype)
    return (a.to(acc) @ b.to(acc)).to(dtype)


def channel_attention_plain(x, wqkv, bqkv, wproj, bproj, num_heads):
    """The forward kernel's arithmetic in PyTorch ops → y (B, N, C)."""
    dt = x.dtype
    scale = (x.shape[-1] // num_heads) ** -0.5
    with torch.autocast(x.device.type, enabled=False):
        q, k, v = _qkv(x, wqkv, bqkv, num_heads)
        pb = _probs(k, v, scale).to(dt)
        of = _merge(_rmm(q, pb.transpose(-1, -2), dt))
        acc = acc_dtype(dt)
        return (of.to(acc) @ wproj.to(acc) + bproj.to(acc)).to(dt)


def channel_attention_bwd_plain(x, dy, wqkv, bqkv, wproj, num_heads
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic → (dqkv (B, N, 3C), of (B, N, C)),
    what skinjax's ``_ch_bwd_kernel`` returns."""
    dt = x.dtype
    scale = (x.shape[-1] // num_heads) ** -0.5
    with torch.autocast(x.device.type, enabled=False):
        q, k, v = _qkv(x, wqkv, bqkv, num_heads)
        do = _heads(_rmm(dy, wproj.t(), dt), num_heads)
        p = _probs(k, v, scale)  # fp32
        pb = p.to(dt)
        of = _rmm(q, pb.transpose(-1, -2), dt)
        dq = _rmm(do, pb, dt)
        dp = do.to(p.dtype).transpose(-1, -2) @ q.to(p.dtype)
        ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt)
        dk = _rmm(v, ds.transpose(-1, -2), dt)
        dv = _rmm(k, ds, dt)
        return torch.cat([_merge(t) for t in (dq, dk, dv)], dim=-1), _merge(of)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(x, wqkv, bqkv, wproj, bproj, num_heads) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"channel attention takes {_DTYPES}; got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C), got {tuple(x.shape)}")
    B, N, C = x.shape
    if C % num_heads or C // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes C divisible by the heads and at most {MAX_HEAD_DIM} "
                         f"channels a head; got C={C}, {num_heads} heads")
    check_tensor("x", x, (B, N, C), x.dtype, x.device)
    check_tensor("wqkv", wqkv, (C, 3 * C), x.dtype, x.device)
    check_tensor("bqkv", bqkv, (3 * C,), x.dtype, x.device)
    check_tensor("wproj", wproj, (C, C), x.dtype, x.device)
    if bproj is not None:
        check_tensor("bproj", bproj, (C,), x.dtype, x.device)


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.skinjax_channel_attention_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def plan(dtype: torch.dtype, B: int, N: int, C: int, num_heads: int, backward: bool) -> dict:
    """The route of a CUDA call of the forward (or backward) and what it
    launches and allocates: ``route`` ("mma": the tensor-core kernels, bf16
    at 32 channels a head and a multiple of ``HEAD_GROUP`` heads, a block
    ``HEAD_GROUP`` heads; else "cuda-core", a block a head), ``n_seg``
    segments of the partial sums, the fp32 ``planes`` (the partial sums, pb,
    and the backward's ds, (hd, hd) each) and the ``scratch`` in the input
    dtype: on the tensor-core route none for the forward and, for the
    backward, q, k, v and do as four (B, N, C) planes; the CUDA-core
    forward's of (B, N, C) and backward's q, k, v, do interleaved, (B, N, 4,
    C)."""
    mma = (dtype == torch.bfloat16 and C == MMA_HEAD_DIM * num_heads
           and num_heads % HEAD_GROUP == 0)
    n_seg = -(-N // SEGMENT)
    hd = C // num_heads
    planes = (2 * n_seg + 2 if backward else n_seg + 1, B, num_heads, hd, hd)
    if mma:
        scratch = (4, B, N, C) if backward else None
    else:
        scratch = (B, N, 4, C) if backward else (B, N, C)
    return dict(route="mma" if mma else "cuda-core", n_seg=n_seg, planes=planes,
                scratch=scratch)


def _scratch(x, p: dict):
    """The plan's fp32 planes and its scratch in x's dtype (or None), cut
    from one allocation; the scratch starts 16-byte aligned."""
    n_planes = math.prod(p["planes"]) * 4
    n = 0 if p["scratch"] is None else math.prod(p["scratch"]) * x.element_size()
    buf = torch.empty(n_planes + n, dtype=torch.uint8, device=x.device)
    planes = buf[:n_planes].view(torch.float32).view(p["planes"])
    scratch = buf[n_planes:].view(x.dtype).view(p["scratch"]) if n else None
    return planes, scratch


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def channel_attention_fwd(x, wqkv, bqkv, wproj, bproj, num_heads):
    """y from the forward kernel (CUDA) or its twin (CPU)."""
    if x.device.type == "cpu":
        return channel_attention_plain(x, wqkv, bqkv, wproj, bproj, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"channel attention takes CPU or CUDA tensors, got {x.device}")
    _check(x, wqkv, bqkv, wproj, bproj, num_heads)
    B, N, C = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    p = plan(x.dtype, B, N, C, num_heads, backward=False)
    n_seg = p["n_seg"]
    planes, of = _scratch(x, p)
    lib = library()
    err = lib.skinjax_channel_attention_fwd(
        int(x.dtype == torch.bfloat16), int(p["route"] == "mma"), x.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), planes.data_ptr(),
        planes[n_seg].data_ptr(), _ptr(of), y.data_ptr(), B, N, C, num_heads, n_seg,
        (C // num_heads) ** -0.5,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, err, "channel_attention_fwd")
    LAUNCHES["channel_attention_fwd"] += 1
    return y


def channel_attention_bwd(x, dy, wqkv, bqkv, wproj, num_heads):
    """(dqkv, of) from the backward kernel (CUDA) or its twin (CPU)."""
    if x.device.type == "cpu":
        return channel_attention_bwd_plain(x, dy, wqkv, bqkv, wproj, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"channel attention takes CPU or CUDA tensors, got {x.device}")
    _check(x, wqkv, bqkv, wproj, None, num_heads)
    check_tensor("dy", dy, tuple(x.shape), x.dtype, x.device)
    B, N, C = x.shape
    dqkv = torch.empty((B, N, 3 * C), dtype=x.dtype, device=x.device)
    of = torch.empty_like(x)
    if x.numel() == 0:
        return dqkv, of
    p = plan(x.dtype, B, N, C, num_heads, backward=True)
    n_seg = p["n_seg"]
    planes, qkvd = _scratch(x, p)
    lib = library()
    err = lib.skinjax_channel_attention_bwd(
        int(x.dtype == torch.bfloat16), int(p["route"] == "mma"), x.data_ptr(), dy.data_ptr(),
        wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(), qkvd.data_ptr(), planes.data_ptr(),
        planes[2 * n_seg].data_ptr(), planes[2 * n_seg + 1].data_ptr(), dqkv.data_ptr(),
        of.data_ptr(), B, N, C, num_heads, n_seg, (C // num_heads) ** -0.5,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, err, "channel_attention_bwd")
    LAUNCHES["channel_attention_bwd"] += 1
    return dqkv, of


def _mm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a·b with fp32 accumulation, rounded to ``dtype``: cuBLAS on the card
    (its bf16 products sum in fp32; TF32 is off), fp32 sums on the CPU."""
    if a.device.type == "cuda":
        return (a @ b).to(dtype)
    return _rmm(a, b, dtype)


class _ChannelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, num_heads):
        ctx.save_for_backward(x, wqkv, bqkv, wproj)
        ctx.num_heads = num_heads
        return channel_attention_fwd(x, wqkv, bqkv, wproj, bproj, num_heads)

    @staticmethod
    def backward(ctx, dy):
        x, wqkv, bqkv, wproj = ctx.saved_tensors
        B, N, C = x.shape
        with torch.autocast(x.device.type, enabled=False):
            dy = dy.to(x.dtype).contiguous()
            dqkv, of = channel_attention_bwd(x, dy, wqkv, bqkv, wproj, ctx.num_heads)
            xf, dyf = x.reshape(-1, C), dy.reshape(-1, C)
            dqkvf, off = dqkv.reshape(-1, 3 * C), of.reshape(-1, C)
            acc = acc_dtype(x.dtype)
            need = ctx.needs_input_grad
            dx = _mm(dqkvf, wqkv.t(), x.dtype).reshape(B, N, C) if need[0] else None
            dwqkv = _mm(xf.t(), dqkvf, wqkv.dtype) if need[1] else None
            dbqkv = dqkvf.to(acc).sum(0).to(bqkv.dtype) if need[2] else None
            dwproj = _mm(off.t(), dyf, wproj.dtype) if need[3] else None
            dbproj = dyf.to(acc).sum(0).to(wproj.dtype) if need[4] else None
        return dx, dwqkv, dbqkv, dwproj, dbproj, None


def channel_attention(x, wqkv, bqkv, wproj, bproj, num_heads: int) -> torch.Tensor:
    """Channel MHA with its projections on x (B, N, C); differentiable in x
    and the weights."""
    return _ChannelAttention.apply(x, wqkv, bqkv, wproj, bproj, num_heads)
