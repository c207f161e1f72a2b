"""On-device image augmentation (counterpart of ``skinjax/data/augment.py``).

The same augmentation distribution as the JAX package, run on the device the
batch lies on:

  default recipe   Rotate(±45°, reflect, p=.5) → HFlip(.5) → VFlip(.2) →
                   GaussianBlur(σ≤2, .25) → CoarseDropout(5×8×8, .15) →
                   HueSaturationValue(10/15/10, .25) →
                   RandomBrightnessContrast(±0.2, .25) → Normalize(ImageNet)
  sentence recipe  Affine scale x/y ~ U(1, 2) p=.25, rotate ±120° p=.25, blur
                   σ≤3 p=.25, OneOf[PixelDropout, CoarseDropout(⌊.00125·H·W⌋
                   4×4)] p=.1, OneOf[MultiplicativeNoise(.9–1.1), HSV(10,10,0)]
                   p=.25, no brightness

Randomness comes from an explicit ``torch.Generator`` on the batch's device.
Its stream differs from ``jax.random``'s, so the port matches skinjax in
distribution, and exactly where both sides are handed the same draws (the
geometry functions take their angles, scales and sigmas; the color kernel its
parameters).

Geometry keeps skinjax's arithmetic: rotation and zoom are the same
reflect-101 pad, floor, clip and bilinear lerp as ``rotate_batch_rows`` /
``zoom_batch_rows``, written as gathers shared across the batch (not
``F.grid_sample``, whose coordinate and border rules differ), and with a
bfloat16 batch the lerp weights and the lerp itself are bfloat16, as in the
JAX pipeline. Rotation, blur and zoom use G = 4 angles/sigmas/scales per batch,
each over one contiguous quarter of the batch when B divides by 4.

On a CUDA batch with the default recipe the color stage (coarse dropout, HSV,
brightness/contrast, normalize) runs as the hand-written kernel
``skinjax_torch.ops.augment_kernel.fused_color_stage`` (K5) unless
``fused_color=False``; on a CPU batch the same call runs its plain twin.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from skinjax_torch.ops import augment_kernel

IMAGENET_MEAN = augment_kernel.IMAGENET_MEAN
IMAGENET_STD = augment_kernel.IMAGENET_STD

DEFAULT_CFG = dict(
    rotate_deg=45.0, p_rotate=0.5, p_hflip=0.5, p_vflip=0.2,
    blur_sigma=2.0, p_blur=0.25, p_dropout=0.15, p_hsv=0.25, p_bc=0.25,
)

SENTENCE_CFG = dict(
    rotate_deg=120.0, p_rotate=0.25, p_hflip=0.5, p_vflip=0.2,
    blur_sigma=3.0, p_blur=0.25, p_dropout=0.1, p_hsv=0.25, p_bc=0.0,
    p_scale=0.25, scale_max=2.0,
    dropout_oneof=True, pixel_drop_max=0.05,
    holes_frac=0.00125, hole_size=4,
    color_oneof=True, noise_lo=0.9, noise_hi=1.1,
    hsv_limits=(10.0, 10.0, 0.0),
)

N_ROT_GROUPS = 4


def _uniform(gen: torch.Generator, *shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _centered_grid(H: int, W: int, device):
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None] - (H - 1) / 2.0
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :] - (W - 1) / 2.0
    return yy, xx


def _lerp4(flat, base, row, wy, wx):
    """Bilinear lerp of the 2×2 texels at ``base`` in ``flat`` (B, N, C),
    with the image dtype's arithmetic; wy/wx are (H·W, 1)."""
    v00, v01 = flat[:, base], flat[:, base + 1]
    v10, v11 = flat[:, base + row], flat[:, base + row + 1]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def rotate_batch_rows(img: torch.Tensor, angle_rad, max_deg: float = 60.0) -> torch.Tensor:
    """Rotate a batch (B, H, W, C) about its centre by one angle: reflect-101
    pad, inverse map, floor, clip, bilinear — the arithmetic of skinjax's
    ``rotate_batch_rows``."""
    B, H, W, C = img.shape
    a = math.radians(max_deg)
    factor = math.sqrt(2.0) if max_deg >= 45.0 else abs(math.cos(a)) + abs(math.sin(a))
    pad = int(math.ceil(max(H, W) / 2.0 * (factor - 1.0))) + 2
    Hp, Wp = H + 2 * pad, W + 2 * pad
    p = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    flat = p.permute(0, 2, 3, 1).reshape(B, Hp * Wp, C)

    yy, xx = _centered_grid(H, W, img.device)
    angle = torch.as_tensor(angle_rad, dtype=torch.float32, device=img.device)
    cos, sin = torch.cos(angle), torch.sin(angle)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    src_y = (cos * yy - sin * xx + cy).expand(H, W) + pad
    src_x = (sin * yy + cos * xx + cx).expand(H, W) + pad
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy = (src_y - y0).reshape(-1, 1).to(img.dtype)
    wx = (src_x - x0).reshape(-1, 1).to(img.dtype)
    y0 = y0.long().clamp(0, Hp - 2).reshape(-1)
    x0 = x0.long().clamp(0, Wp - 2).reshape(-1)
    return _lerp4(flat, y0 * Wp + x0, Wp, wy, wx).reshape(B, H, W, C)


def zoom_batch_rows(img: torch.Tensor, sy, sx) -> torch.Tensor:
    """Zoom a batch in about its centre (scale ≥ 1), the arithmetic of
    skinjax's ``zoom_batch_rows``: source coordinates stay inside the image,
    so the base texel is clipped before the lerp weights are taken."""
    B, H, W, C = img.shape
    flat = img.reshape(B, H * W, C)
    yy, xx = _centered_grid(H, W, img.device)
    sy = torch.as_tensor(sy, dtype=torch.float32, device=img.device)
    sx = torch.as_tensor(sx, dtype=torch.float32, device=img.device)
    src_y = (yy / sy + (H - 1) / 2.0).expand(H, W)
    src_x = (xx / sx + (W - 1) / 2.0).expand(H, W)
    y0 = torch.floor(src_y).long().clamp(0, H - 2)
    x0 = torch.floor(src_x).long().clamp(0, W - 2)
    wy = (src_y - y0).reshape(-1, 1).to(img.dtype)
    wx = (src_x - x0).reshape(-1, 1).to(img.dtype)
    return _lerp4(flat, (y0 * W + x0).reshape(-1), W, wy, wx).reshape(B, H, W, C)


def _reflect_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect-101 border of an unpadded index."""
    period = 2 * n - 2
    i = torch.remainder(i.abs(), period)
    return (n - 1) - (i - (n - 1)).abs()


def rotate(img: torch.Tensor, angle_rad) -> torch.Tensor:
    """Rotate (B, H, W, C) about the centre with reflect-101 indices and no
    padding (skinjax's per-sample ``rotate``; used when B does not divide
    into the groups)."""
    B, H, W, C = img.shape
    yy, xx = _centered_grid(H, W, img.device)
    angle = torch.as_tensor(angle_rad, dtype=torch.float32, device=img.device)
    cos, sin = torch.cos(angle), torch.sin(angle)
    src_y = (cos * yy - sin * xx + (H - 1) / 2.0).expand(H, W)
    src_x = (sin * yy + cos * xx + (W - 1) / 2.0).expand(H, W)
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy = (src_y - y0)[..., None].to(img.dtype)
    wx = (src_x - x0)[..., None].to(img.dtype)
    y0, x0 = y0.long(), x0.long()
    y0r, y1r = _reflect_index(y0, H), _reflect_index(y0 + 1, H)
    x0r, x1r = _reflect_index(x0, W), _reflect_index(x0 + 1, W)
    v00, v01 = img[:, y0r, x0r], img[:, y0r, x1r]
    v10, v11 = img[:, y1r, x0r], img[:, y1r, x1r]
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


def gaussian_blur_batch(img: torch.Tensor, sigma, ksize: int = 7) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W, C): two depthwise convolutions,
    each after a reflect-101 pad; ``sigma`` 0 is the identity."""
    r = ksize // 2
    C = img.shape[-1]
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    sigma = torch.clamp_min(torch.as_tensor(sigma, dtype=torch.float32, device=img.device), 1e-6)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).to(img.dtype)
    nchw = img.permute(0, 3, 1, 2)
    out = F.conv2d(F.pad(nchw, (0, 0, r, r), mode="reflect"),
                   k.reshape(1, 1, ksize, 1).expand(C, 1, ksize, 1), groups=C)
    out = F.conv2d(F.pad(out, (r, r, 0, 0), mode="reflect"),
                   k.reshape(1, 1, 1, ksize).expand(C, 1, 1, ksize), groups=C)
    return out.permute(0, 2, 3, 1)


def _grouped(img, gen, params, gate_p, fn):
    """Apply ``fn(slice, params[g])`` per group g with a per-sample gate: on
    contiguous quarters when B divides by G, else on the whole batch per group
    with a drawn group index per sample (skinjax's ``_*_groups``)."""
    B = img.shape[0]
    G = N_ROT_GROUPS
    gate = _uniform(gen, B) < gate_p
    if B % G == 0:
        S = B // G
        outs = []
        for g in range(G):
            sl = img[g * S:(g + 1) * S]
            mask = gate[g * S:(g + 1) * S, None, None, None]
            outs.append(torch.where(mask, fn(sl, params[g]), sl))
        return torch.cat(outs)
    grp = torch.randint(0, G, (B,), generator=gen, device=gen.device)
    out = img
    for g in range(G):
        mask = (gate & (grp == g))[:, None, None, None]
        out = torch.where(mask, fn(img, params[g]), out)
    return out


def _rotate_groups(img, gen, cfg):
    deg = cfg["rotate_deg"]
    angles = _uniform(gen, N_ROT_GROUPS, lo=-deg, hi=deg) * (math.pi / 180.0)
    if img.shape[0] % N_ROT_GROUPS == 0:
        fn = lambda sl, a: rotate_batch_rows(sl, a, max_deg=deg)  # noqa: E731
    else:
        fn = rotate
    return _grouped(img, gen, angles, cfg["p_rotate"], fn)


def _blur_groups(img, gen, cfg):
    sigmas = _uniform(gen, N_ROT_GROUPS, hi=cfg["blur_sigma"])
    return _grouped(img, gen, sigmas, cfg["p_blur"], gaussian_blur_batch)


def _scale_groups(img, gen, cfg):
    scales = _uniform(gen, N_ROT_GROUPS, 2, lo=1.0, hi=cfg["scale_max"])
    return _grouped(img, gen, scales, cfg["p_scale"],
                    lambda sl, s: zoom_batch_rows(sl, s[0], s[1]))


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), 0.0)
    safe = torch.clamp_min(delta, 1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, 0.0, h)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6)

    def select(*vals):
        out = vals[5]
        for idx in (4, 3, 2, 1, 0):
            out = torch.where(i == idx, vals[idx], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def _hole_mask(B, H, W, ys, xs, n_active, hole, device):
    """1 outside and 0 inside the active holes: (B, H, W). ``ys``/``xs`` are
    (B, K) hole corners; the first ``n_active`` (B,) holes are active. The
    union of squares is a sum of row-band × column-band outer products."""
    K = ys.shape[1]
    active = (torch.arange(K, device=device)[None] < n_active[:, None]).float()  # (B, K)
    yy = torch.arange(H, device=device)[None, None]
    xx = torch.arange(W, device=device)[None, None]
    rows = ((yy >= ys[..., None]) & (yy < ys[..., None] + hole)).float() * active[..., None]
    cols = ((xx >= xs[..., None]) & (xx < xs[..., None] + hole)).float()
    covered = torch.bmm(rows.transpose(1, 2), cols)  # (B, H, W): holes covering each pixel
    return (covered == 0).float()


def _coarse_dropout(img, gen, max_holes=5, hole=8, min_holes=1):
    B, H, W, _ = img.shape
    dev = img.device
    ys = torch.randint(0, max(H - hole, 1), (B, max_holes), generator=gen, device=dev)
    xs = torch.randint(0, max(W - hole, 1), (B, max_holes), generator=gen, device=dev)
    n = torch.randint(min_holes, max_holes + 1, (B,), generator=gen, device=dev)
    return img * _hole_mask(B, H, W, ys, xs, n, hole, dev)[..., None]


def _pixel_dropout(img, gen, max_prob=0.05):
    B, H, W, _ = img.shape
    prob = _uniform(gen, B, 1, 1, hi=max_prob)
    return img * (_uniform(gen, B, H, W) >= prob).float()[..., None]


def _color_chain(img: torch.Tensor, gen: torch.Generator, cfg: Mapping) -> torch.Tensor:
    """The per-sample chain of skinjax's ``_augment_one`` on a whole batch
    (each sample draws its own gates and parameters): flips → dropout → HSV
    (or the sentence recipe's OneOf with multiplicative noise) → brightness/
    contrast. Computes in float32 and returns the input dtype."""
    in_dtype = img.dtype
    img = img.float()
    B, H, W, _ = img.shape

    def gate(p):
        return (_uniform(gen, B) < p)[:, None, None, None]

    img = torch.where(gate(cfg["p_hflip"]), img.flip(2), img)
    img = torch.where(gate(cfg["p_vflip"]), img.flip(1), img)

    if cfg.get("dropout_oneof"):
        n_holes = max(1, int(cfg["holes_frac"] * H * W))
        dropped = torch.where(gate(0.5), _pixel_dropout(img, gen, cfg["pixel_drop_max"]),
                              _coarse_dropout(img, gen, n_holes, cfg["hole_size"], n_holes))
    else:
        dropped = _coarse_dropout(img, gen)
    img = torch.where(gate(cfg["p_dropout"]), dropped, img)

    hl, sl, vl = cfg.get("hsv_limits", (10.0, 15.0, 10.0))
    do_hsv = gate(cfg["p_hsv"])
    sh = _uniform(gen, B, 1, 1, 3, lo=-1.0, hi=1.0) * do_hsv
    hsv = rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + sh[..., 0] * (hl / 180.0), 1.0)
    s = torch.clamp(hsv[..., 1] + sh[..., 1] * (sl / 255.0), 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] + sh[..., 2] * (vl / 255.0), 0.0, 1.0)
    hsved = hsv_to_rgb(torch.stack([h, s, v], dim=-1))

    if cfg.get("color_oneof"):
        pick_noise = gate(0.5)
        per_ch = gate(0.5)
        mul = _uniform(gen, B, 1, 1, 3, lo=cfg["noise_lo"], hi=cfg["noise_hi"])
        mul = torch.where(per_ch, mul, mul[..., :1])
        noised = torch.clamp(img * mul, 0.0, 1.0)
        img = torch.where(do_hsv & pick_noise, noised, torch.where(do_hsv, hsved, img))
        return img.to(in_dtype)

    do_bc = gate(cfg["p_bc"]).float()
    ab = _uniform(gen, B, 1, 1, 2, lo=-0.2, hi=0.2)
    alpha = 1.0 + ab[..., :1] * do_bc
    beta = ab[..., 1:] * do_bc
    return torch.clamp(hsved * alpha + beta, 0.0, 1.0).to(in_dtype)


# ---------------------------------------------------------------------------
# the batch entry point
# ---------------------------------------------------------------------------


def normalize(img: torch.Tensor) -> torch.Tensor:
    """ImageNet normalize in the image's dtype."""
    mean = torch.tensor(IMAGENET_MEAN, device=img.device).to(img.dtype)
    std = torch.tensor(IMAGENET_STD, device=img.device).to(img.dtype)
    return (img - mean) / std


def _eval_normalize_f32(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 → normalized float32 with the reference's arithmetic: XLA turns
    ``(u8 / 255 − mean) / std`` into ``fma(u8, f32(1/255), −mean) · f32(1/std)``.
    The product and difference are exact in float64 (8 × 24 significant bits,
    then an aligned subtraction), so one cast to float32 is the fused
    multiply-add's single rounding."""
    dev = images_u8.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    inv_std = 1.0 / torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    inv_255 = float(torch.tensor(1.0) / torch.tensor(255.0))  # the float32 reciprocal
    return (images_u8.double() * inv_255 - mean.double()).float() * inv_std


@torch.no_grad()
def augment_batch(images_u8: torch.Tensor, gen: Optional[torch.Generator] = None,
                  train: bool = True, out_dtype: torch.dtype = torch.float32,
                  fused_color: bool = True, recipe: str = "default") -> torch.Tensor:
    """uint8 (B, H, W, 3) → normalized (B, H, W, 3) in ``out_dtype``, on the
    batch's device. Train: the stochastic pipeline, drawn from ``gen`` (a
    generator on the batch's device); eval: normalize only.

    The pipeline computes in bfloat16 when ``out_dtype`` is bfloat16, else in
    float32. ``fused_color`` runs the color stage as K5,
    ``ops.augment_kernel.fused_color_stage``; False runs the per-sample chain. The sentence recipe always runs its chain: the kernel
    implements the default recipe's color stage."""
    compute = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    if not train and compute == torch.float32:
        return _eval_normalize_f32(images_u8).to(out_dtype)
    img = images_u8.to(compute) / torch.tensor(255.0, dtype=compute, device=images_u8.device)
    if not train:
        return normalize(img).to(out_dtype)
    if gen is None:
        raise ValueError("augment_batch(train=True) needs a torch.Generator")
    if gen.device != images_u8.device:
        raise ValueError(f"the generator is on {gen.device}, the batch on {images_u8.device}")
    if recipe == "sentence":
        fused_color = False

    cfg = SENTENCE_CFG if recipe == "sentence" else DEFAULT_CFG
    if cfg.get("p_scale", 0.0) > 0.0:
        img = _scale_groups(img, gen, cfg)
    img = _rotate_groups(img, gen, cfg)
    img = _blur_groups(img, gen, cfg)

    if fused_color:
        B, H, W, _ = img.shape
        u = _uniform(gen, B, 2)
        img = torch.where((u[:, 0] < cfg["p_hflip"])[:, None, None, None], img.flip(2), img)
        img = torch.where((u[:, 1] < cfg["p_vflip"])[:, None, None, None], img.flip(1), img)
        fparams, iparams = augment_kernel.draw_color_params(gen, B, H, W, cfg)
        return augment_kernel.fused_color_stage(img.contiguous(), fparams, iparams,
                                                out_dtype=out_dtype)
    return normalize(_color_chain(img, gen, cfg)).to(out_dtype)
