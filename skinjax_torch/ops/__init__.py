"""Operators and the hand-written CUDA kernels behind them."""


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
