"""BatchNorm: the flax-biased modules, and train-mode BatchNorm whose
per-channel sums run in a hand-written CUDA kernel pair (K6).

Counterpart of ``skinjax/ops/pallas/bn_kernels.py`` and
``skinjax/ops/fused_bn.py``:

  kernel          CUDA entry point (csrc/bn_kernels.cu)  replaces (Pallas TPU kernel)
  bn_stats        skinjax_bn_stats                       bn_kernels.py bn_stats (_stats_kernel)
  bn_grad_stats   skinjax_bn_grad_stats                  bn_kernels.py bn_grad_stats (_grad_stats_kernel)

Layout. skinjax's kernels take (..., C) arrays. Here x has PyTorch's
BatchNorm layout, channels at dim 1: an (N, C, H, W) map or a (B, C) /
(B, C, L) batch. The kernels read x as rows of C contiguous channels, which is
what a channels_last map is (the port's convs on the card are) and what the
(B, C, N) view of a (B, N, C) token tensor is; skinjax's (..., C) array is
``x.movedim(1, -1)``. A CUDA tensor in another layout raises: the wrappers
never copy. ``batch_norm_train``'s backward lays its incoming gradient out
as x where it is not (the gradient of a mean pool is a broadcast) with one
visible copy, counted in ``COPIES``.

``batch_norm_train(x, weight, bias, eps) → (y, mean, var)`` is skinjax's
custom VJP ``batch_norm_train`` step for step, with its rounding points:
``var = max(Σx²/n − mean², 0)``; ``mul``, ``add`` rounded to x's dtype;
``y = x·mul + add`` (one rounding: ``addcmul`` computes in fp32, as XLA's
fused multiply-add); the backward's ``k1`` rounded to x's dtype, dx computed
in fp32 and cast once. mean and var are the biased batch statistics for the
running averages, not differentiated. The normalize and the dx pass are
plain PyTorch elementwise ops, as they are XLA ops outside the Pallas call in
skinjax.

``BatchNorm2d``/``BatchNorm1d`` are ``nn.BatchNorm2d``/``nn.BatchNorm1d``
with flax's running variance (the biased batch variance; momentum 0.1 here
is flax's 0.9): the towers' native route. ``FusedBatchNorm2d`` and
``FusedBatchNorm1d`` subclass them with the same ``state_dict``; in train
mode they run ``batch_norm_train``, in eval mode the plain normalize of
skinjax's ``FusedBatchNorm``. ``fuse_batch_norms(module)`` swaps every
``BatchNorm2d``/``BatchNorm1d`` of a module for its fused subclass in place,
parameters and buffers kept: the drop-in of skinjax's ``fused_bn.py``.

``bn_stats_reference`` and ``bn_grad_stats_reference`` are the plain PyTorch
twins. The wrappers dispatch on x's device: a CPU tensor goes to the twin, a
CUDA tensor launches the kernel or raises. There is no fallback from a failed
build or launch. ``LAUNCHES`` counts calls that launched a kernel pair (a
twin call is not counted).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch import nn

from skinjax_torch.ops import acc_dtype

LAUNCHES: Dict[str, int] = {"bn_stats": 0, "bn_grad_stats": 0}
# gradients laid out anew as x by batch_norm_train's backward on the card
COPIES: Dict[str, int] = {"dy": 0}

THREADS = 256  # a block of bn_partial_kernel (csrc kThreads)
TARGET_BLOCKS = 8 * 132  # blocks of the first launch: 8 a SM of an H100

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "skinjax_bn_error_string": ([_I], ctypes.c_char_p),
    "skinjax_bn_stats": ([_I, _P, _P, _P] + [_I] * 6 + [_P], _I),
    "skinjax_bn_grad_stats": ([_I, _P, _P, _P, _P] + [_I] * 6 + [_P], _I),
}
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    COPIES["dy"] = 0


def library():
    """The kernels' shared library, built with nvcc on first use (raises if
    the build fails)."""
    from skinjax_torch.ops import build

    return build.load("bn_kernels", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain twins (the reference for the kernels, and the CPU path)
# ---------------------------------------------------------------------------


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, ...) → (M, C) rows, channels last."""
    return t.movedim(1, -1).reshape(-1, t.shape[1])


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) per channel (dim 1), summed in fp32 (fp64 for fp64)."""
    r = _rows(x).to(acc_dtype(x.dtype))
    return r.sum(0), (r * r).sum(0)


def bn_grad_stats_reference(x: torch.Tensor, dy: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σdy, Σdy·x) per channel (dim 1), summed in fp32 (fp64 for fp64)."""
    acc = acc_dtype(x.dtype)
    r, g = _rows(x).to(acc), _rows(dy).to(acc)
    return g.sum(0), (g * r).sum(0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def rows_contiguous(t: torch.Tensor) -> bool:
    """Whether t is rows of C contiguous channels (channels_last, or the
    (B, C, N) view of a (B, N, C) tensor): the layout the kernels read."""
    return t.dim() >= 2 and t.movedim(1, -1).is_contiguous()


def plan(M: int, C: int, itemsize: int, aligned: bool) -> Tuple[int, int, int, int]:
    """(vec, tx, seg_rows, n_seg) of the first launch: 16-byte loads where C
    and the pointers allow; tx threads along the channel vectors (a power of
    two ≤ 32) and 256/tx along the rows; the rows cut into segments (a
    multiple of 256/tx rows each) so that about TARGET_BLOCKS blocks run.
    Shapes alone decide it, so the order of every sum is fixed."""
    vec = 16 // itemsize
    if C % vec or not aligned:
        vec = 1
    nvec = C // vec
    tx = 1
    while tx < min(nvec, 32):
        tx *= 2
    ty = THREADS // tx
    tiles = -(-nvec // tx)
    target = max(1, -(-TARGET_BLOCKS // tiles))
    seg_rows = max(ty, -(-M // target))
    seg_rows = -(-seg_rows // ty) * ty
    return vec, tx, seg_rows, -(-M // seg_rows)


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} takes {_DTYPES}; got {t.dtype}")
    if t.dtype != like.dtype or t.shape != like.shape or t.device != like.device:
        raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)} on {t.device} does not match x's "
                         f"{like.dtype}{tuple(like.shape)} on {like.device}")
    if not rows_contiguous(t):
        raise ValueError(f"{name} reads rows of C contiguous channels (channels_last, or the "
                         f"(B, C, N) view of (B, N, C) tokens); got shape {tuple(t.shape)}, "
                         f"strides {t.stride()}")


def _launch(name: str, x: torch.Tensor, dy=None) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {x.device}")
    _check("x", x, x)
    if dy is not None:
        _check("dy", dy, x)
    C = x.shape[1]
    M = x.numel() // C if C else 0
    if M == 0:
        out = torch.zeros((2, C), dtype=torch.float32, device=x.device)
        return out[0], out[1]
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy) if t is not None)
    vec, tx, seg_rows, n_seg = plan(M, C, x.element_size(), aligned)
    part = torch.empty((n_seg, 2, C), dtype=torch.float32, device=x.device)
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = int(x.dtype == torch.bfloat16)
    if dy is None:
        err = lib.skinjax_bn_stats(bf16, x.data_ptr(), part.data_ptr(), out.data_ptr(), M, C, vec,
                                   tx, seg_rows, n_seg, stream)
    else:
        err = lib.skinjax_bn_grad_stats(bf16, x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                                        out.data_ptr(), M, C, vec, tx, seg_rows, n_seg, stream)
    if err != 0:
        msg = lib.skinjax_bn_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[name] += 1
    return out[0], out[1]


def bn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) per channel, fp32 (C,): the kernel pair (CUDA) or its twin
    (CPU)."""
    if x.device.type == "cpu":
        return bn_stats_reference(x)
    return _launch("bn_stats", x)


def bn_grad_stats(x: torch.Tensor, dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σdy, Σdy·x) per channel, fp32 (C,): the kernel pair (CUDA) or its
    twin (CPU)."""
    if x.device.type == "cpu":
        return bn_grad_stats_reference(x, dy)
    return _launch("bn_grad_stats", x, dy)


# ---------------------------------------------------------------------------
# batch_norm_train: skinjax's custom VJP
# ---------------------------------------------------------------------------


def _channel(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast along x's dim 1."""
    return t.view(1, -1, *([1] * (x.dim() - 2)))


def _like(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dy laid out as x's rows: as it is where it already is, else copied
    once (counted) on the card; the CPU twins take any layout."""
    if dy.device.type == "cpu" or rows_contiguous(dy):
        return dy
    COPIES["dy"] += 1
    return torch.empty_like(x).copy_(dy)


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        n = x.numel() // x.shape[1]
        s, q = bn_stats(x)
        mean = s / n
        var = torch.clamp_min(q / n - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        w = weight.to(mean.dtype)
        mul = (rstd * w).to(x.dtype)
        add = (bias.to(mean.dtype) - mean * rstd * w).to(x.dtype)
        y = torch.addcmul(_channel(add, x), x, _channel(mul, x))
        ctx.save_for_backward(x, weight, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, var = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        rstd = torch.rsqrt(var + ctx.eps)
        gy = _like(gy.to(x.dtype), x)
        sdy, sdyx = bn_grad_stats(x, gy)
        # Σ dy·xhat = (Σ dy·x − mean·Σ dy)·rstd
        dscale = (sdyx - mean * sdy) * rstd
        dx = None
        if ctx.needs_input_grad[0]:
            # dx = k1·(dy − Σdy/n − xhat·dscale/n), k1 = scale·rstd rounded to
            # x's dtype; fp32 throughout, written once in x's dtype
            k1 = (weight.to(rstd.dtype) * rstd).to(x.dtype).to(rstd.dtype)
            t = torch.addcmul(_channel(sdy / n, x), x - _channel(mean, x),
                              _channel(rstd * (dscale / n), x))
            dx = torch.mul(gy - t, _channel(k1, x), out=torch.empty_like(x))
        return dx, dscale.to(weight.dtype), sdy.to(weight.dtype), None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm over dim 1 with K6's sums → (y, mean, var); mean
    and var (fp32, biased) are not differentiated."""
    return _BatchNormTrain.apply(x, weight, bias, eps)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class _FlaxRunningVar:
    """Train-mode forward whose running variance is the *biased* batch
    variance, as flax's BatchNorm stores it (momentum 0.9 in flax is 0.1
    here); torch's own update stores the unbiased one, n/(n−1) larger.

    The running statistics are updated from the statistics that the
    normalization itself computed (``torch.native_batch_norm`` returns the
    batch mean and 1/sqrt(var + eps)), so the update is (C,)-sized work and
    no second pass over the activation."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        self._update(mean, invstd.float().pow(-2) - self.eps)
        return y

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(1.0 - self.momentum).add_(mean.float(), alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var.float(), alpha=self.momentum)
        self.num_batches_tracked.add_(1)


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running variance."""


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running variance (NextViT's pooled
    tokens, as a (B, C, N) view)."""


class FusedBatchNorm:
    """skinjax's ``FusedBatchNorm``: train mode through ``batch_norm_train``
    (K6's sums), the running statistics updated with its biased batch
    variance; eval mode the plain normalize ``x·mul + add``, ``mul`` and
    ``add`` rounded to x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if self.training:
            y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps)
            self._update(mean, var)
            return y
        rstd = torch.rsqrt(self.running_var + self.eps)
        mul = (rstd * self.weight).to(x.dtype)
        add = (self.bias - self.running_mean * rstd * self.weight).to(x.dtype)
        return torch.addcmul(_channel(add, x), x, _channel(mul, x))


class FusedBatchNorm2d(FusedBatchNorm, BatchNorm2d):
    pass


class FusedBatchNorm1d(FusedBatchNorm, BatchNorm1d):
    pass


_FUSED = {BatchNorm2d: FusedBatchNorm2d, BatchNorm1d: FusedBatchNorm1d}


def fuse_batch_norms(module: nn.Module) -> nn.Module:
    """Every ``BatchNorm2d``/``BatchNorm1d`` of ``module`` becomes its fused
    subclass, in place (the same object, parameters and buffers kept);
    returns ``module``."""
    for m in module.modules():
        if type(m) in _FUSED:
            m.__class__ = _FUSED[type(m)]
    return module


def count_batch_norms(module: nn.Module) -> int:
    """The fused BatchNorms of a module: K6's stats launches per train forward."""
    return sum(isinstance(m, FusedBatchNorm) for m in module.modules())
