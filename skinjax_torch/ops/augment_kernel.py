"""The color stage of the training augmentation as a hand-written CUDA kernel.

Counterpart of ``skinjax/ops/pallas/augment_kernel.py`` (K5). Per pixel, in
one pass: coarse dropout → RGB→HSV, shift, HSV→RGB → brightness/contrast →
ImageNet normalize → cast to the output dtype.

  kernel              CUDA entry point (csrc/augment_kernel.cu)  replaces (Pallas TPU kernel)
  fused_color_stage   skinjax_fused_color_stage                  augment_kernel.py fused_color_stage

``fused_color_stage_plain`` is its plain PyTorch twin with the same signature.
The wrapper dispatches on the device of the image: a CPU tensor goes to the
twin, a CUDA tensor launches the kernel or raises. There is no fallback from a
failed build or launch to the twin.

Images are NHWC ``(B, H, W, 3)`` in [0, 1], float32 or bfloat16. Parameters
are per image, drawn by ``draw_color_params`` outside the kernel, so the
kernel and the twin see the same random draws:

    fparams (B, 8) float32  [do_dropout, do_hsv, hue, sat, val, do_bc, alpha, beta]
    iparams (B, 12) int32   [n_holes, hole, ys0..ys4, xs0..xs4]

Both compute in float32 from the same input with the same operations in the
same order, and round to the output dtype once, at the end. What bounds the
kernel on an H100, and what its design does about it, is in the source note
of ``csrc/augment_kernel.cu``.

``LAUNCHES`` counts kernel launches (a twin call is not counted), so a caller
can show that a path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Tuple

import torch

from skinjax_torch.ops import check_tensor

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MAX_HOLES = 5

LAUNCHES: Dict[str, int] = {"fused_color_stage": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "skinjax_augment_error_string": ([_I], ctypes.c_char_p),
    "skinjax_fused_color_stage": ([_I, _I] + [_P] * 4 + [_I] * 3 + [_P], _I),
    "skinjax_k5_division_check": ([_P, _I, _P], _I),
}
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library():
    """The kernel's shared library, built with nvcc on first use (raises if
    the build fails)."""
    from skinjax_torch.ops import build

    return build.load("augment_kernel", _SIGNATURES)


def draw_color_params(gen: torch.Generator, B: int, H: int, W: int, cfg: Mapping,
                      hole: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image random draws for the color stage, on ``gen``'s device: the
    distributions of ``skinjax.ops.pallas.augment_kernel.draw_color_params``.
    Returns fparams (B, 8) float32 and iparams (B, 12) int32."""
    dev = gen.device

    def uniform(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    do_drop = (uniform(B) < cfg["p_dropout"]).float()
    do_hsv = (uniform(B) < cfg["p_hsv"]).float()
    sh = uniform(B, 3, lo=-1.0, hi=1.0)
    do_bc = (uniform(B) < cfg["p_bc"]).float()
    ab = uniform(B, 2, lo=-0.2, hi=0.2)
    fparams = torch.stack([do_drop, do_hsv, sh[:, 0] * (10.0 / 180.0), sh[:, 1] * (15.0 / 255.0),
                           sh[:, 2] * (10.0 / 255.0), do_bc, 1.0 + ab[:, 0], ab[:, 1]], dim=1)
    n_holes = torch.randint(1, MAX_HOLES + 1, (B, 1), generator=gen, device=dev)
    ys = torch.randint(0, max(H - hole, 1), (B, MAX_HOLES), generator=gen, device=dev)
    xs = torch.randint(0, max(W - hole, 1), (B, MAX_HOLES), generator=gen, device=dev)
    iparams = torch.cat([n_holes, torch.full_like(n_holes, hole), ys, xs], dim=1)
    return fparams.contiguous(), iparams.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# plain twin (the reference for the kernel, and the CPU path)
# ---------------------------------------------------------------------------


def _mod1(x: torch.Tensor) -> torch.Tensor:
    """x mod 1 with the sign of the divisor (jnp's %, torch.remainder)."""
    return x - torch.floor(x)


def fused_color_stage_plain(img, fparams, iparams, out_dtype=torch.bfloat16):
    """The kernel's arithmetic in PyTorch ops, float32. Every division takes a
    tensor divisor: on CUDA a Python-scalar divisor becomes a multiply by its
    reciprocal, which rounds differently from the kernel's IEEE division."""
    B, H, W, _ = img.shape
    dev = img.device
    x = img.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]

    def col(j):  # fparams[:, j] broadcast over (H, W)
        return fparams[:, j, None, None]

    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    n_holes, hole = iparams[:, 0, None, None], iparams[:, 1, None, None]
    mask = torch.ones((B, H, W), device=dev)
    for i in range(MAX_HOLES):
        ys, xs = iparams[:, 2 + i, None, None], iparams[:, 7 + i, None, None]
        inside = (yy >= ys) & (yy < ys + hole) & (xx >= xs) & (xx < xs + hole)
        active = (n_holes > i).float() * col(0)
        mask = mask * (1.0 - inside.float() * active)
    r, g, b = r * mask, g * mask, b * mask

    one = torch.ones((), device=dev)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.clamp_min(delta, 1e-12)
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), 0.0)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, 0.0, _mod1(h / (6.0 * one)))

    do_hsv = col(1)
    h = _mod1(h + col(2) * do_hsv)
    s = torch.clamp(s + col(3) * do_hsv, 0.0, 1.0)
    v = torch.clamp(maxc + col(4) * do_hsv, 0.0, 1.0)

    h6 = h * 6.0
    i6 = torch.floor(h6)
    f = h6 - i6
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = i6.long() % 6

    def pick(*vals):
        out = vals[5]
        for idx in (4, 3, 2, 1, 0):
            out = torch.where(sector == idx, vals[idx], out)
        return out

    rgb = torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                       pick(p, p, t, v, v, q)], dim=-1)
    do_bc = col(5)[..., None]
    alpha = 1.0 + (fparams[:, 6, None, None, None] - 1.0) * do_bc
    beta = fparams[:, 7, None, None, None] * do_bc
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return ((torch.clamp(rgb * alpha + beta, 0.0, 1.0) - mean) / std).to(out_dtype)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


def fused_color_stage(img, fparams, iparams, out_dtype=torch.bfloat16):
    """img (B, H, W, 3) float32/bfloat16 in [0, 1]; fparams (B, 8) float32;
    iparams (B, 12) int32 → normalized (B, H, W, 3) in ``out_dtype``."""
    if img.device.type == "cpu":
        return fused_color_stage_plain(img, fparams, iparams, out_dtype)
    if img.device.type != "cuda":
        raise ValueError(f"fused_color_stage takes CPU or CUDA tensors, got {img.device}")
    if img.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"fused_color_stage takes {_DTYPES}; got {img.dtype} → {out_dtype}")
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"img must be (B, H, W, 3), got {tuple(img.shape)}")
    B, H, W, _ = img.shape
    check_tensor("img", img, (B, H, W, 3), img.dtype, img.device)
    check_tensor("fparams", fparams, (B, 8), torch.float32, img.device)
    check_tensor("iparams", iparams, (B, 12), torch.int32, img.device)
    out = torch.empty((B, H, W, 3), dtype=out_dtype, device=img.device)
    if out.numel() == 0:
        return out
    lib = library()
    err = lib.skinjax_fused_color_stage(
        int(img.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), img.data_ptr(),
        fparams.data_ptr(), iparams.data_ptr(), out.data_ptr(), B, H, W,
        torch.cuda.current_stream(img.device).cuda_stream,
    )
    if err != 0:
        msg = lib.skinjax_augment_error_string(err).decode()
        raise RuntimeError(f"fused_color_stage kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES["fused_color_stage"] += 1
    return out


def division_mismatches(device, blocks: int = 1024) -> Tuple[int, int, int]:
    """How many of the floats that ``clip01`` can return (all of [0, 1], and
    -0) the kernel's normalize, a product with the reciprocal and one fused
    multiply-add correction, maps to other bits than the IEEE quotient
    ``(c - mean) / std``: one count a channel, on the card (CUDA only)."""
    bad = torch.empty((blocks, 3), dtype=torch.int32, device=device)
    lib = library()
    err = lib.skinjax_k5_division_check(bad.data_ptr(), blocks,
                                        torch.cuda.current_stream(bad.device).cuda_stream)
    if err != 0:
        msg = lib.skinjax_augment_error_string(err).decode()
        raise RuntimeError(f"k5_division_check kernel launch failed: CUDA error {err} ({msg})")
    return tuple(int(n) for n in bad.sum(dim=0, dtype=torch.int64).tolist())
