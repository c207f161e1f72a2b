"""Operators and the hand-written CUDA kernels behind them."""

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain twins' sums' dtype: fp32, or fp64 for fp64 inputs (the
    gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The autocast dtype where autocast is on, else x's dtype: the dtype a
    module hands its kernel."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def weight_t(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Linear's (out, in) weight as the contiguous (in, out) matrix the
    kernels take, in ``dtype``: one device copy in either dtype, through
    which autograd carries the gradient back to ``w``. (``w.t().to(dtype,
    memory_format=torch.contiguous_format)`` returns the transposed view
    itself, not contiguous, where ``dtype`` is already ``w``'s.)"""
    out = torch.empty((w.shape[1], w.shape[0]), dtype=dtype, device=w.device)
    return out.copy_(w.t())


def check_tensor(name: str, t, shape, dtype, device) -> None:
    """What a kernel wrapper checks of each tensor before it passes a
    pointer: device, dtype, shape and contiguity; raises on a mismatch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
