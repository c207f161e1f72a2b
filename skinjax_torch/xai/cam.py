"""Class activation maps: Grad-CAM, Grad-CAM++ and Score-CAM through the
model's ``capture``/``feature_delta`` injection point (counterpart of
``skinjax/xai/cam.py``; no hooks).

The tower exposes one spatial grid A (B, h, w, C) (``models/backbones/
capture.py``), and ``torch.autograd.grad`` of the class scores with respect
to a zero delta added to it gives g = ∂score/∂A in one backward. The delta
is the only tensor the backward is asked for: while a CAM runs, the model is
in eval mode and no parameter requires a gradient (both are restored after),
so no ``.grad`` is left anywhere and the autograd graph starts at the
injection point. On a tower whose attention or MLP runs a kernel, only the
blocks after that point keep what their backward needs (K12's P) and run a
backward kernel.

The forward is the model's modules, not the fused serving engine (which has
no backward), as skinjax's CAM runs ``model.apply``. Every function takes
the model, a normalized image batch (B, H, W, 3) and its metadata as tensors
on the model's device, and ``class_idx`` (B,) ints, and returns the maps
(B, H, W) in [0, 1], fp32, on that device.

Upsampling to the image size is ``F.interpolate`` bilinear with half-pixel
centres and no antialias, which is what ``jax.image.resize(..., "bilinear")``
computes when it enlarges (``tests/test_torch_xai.py`` holds the two
together). Score-CAM picks its top channels by a stable descending sort,
which breaks ties toward the lower index as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from skinjax_torch.models.backbones.capture import DeltaProbe


@contextlib.contextmanager
def cam_mode(model: torch.nn.Module):
    """Eval mode and no parameter requiring a gradient, restored after."""
    training = model.training
    flags = [(p, p.requires_grad) for p in model.parameters()]
    model.eval()
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)
        model.train(training)


def _no_feature_map():
    return ValueError(
        "backbone returns no spatial feature map: a tower must take capture/feature_delta "
        "(models/backbones/capture.py) or return an NHWC map for the CAM family to work")


def _as_index(class_idx, device) -> torch.Tensor:
    """Class indices (a list, an array or a tensor) as a long tensor on ``device``."""
    return torch.as_tensor(class_idx, dtype=torch.long, device=device)


def grads_and_activations(model, image, metadata, class_idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, g): the grid and d(score)/d(grid), both fp32 (B, h, w, C), from
    one forward and one backward."""
    probe = DeltaProbe()
    with cam_mode(model), torch.enable_grad():
        logits, aux = model(image, metadata, capture=True, feature_delta=probe)
        if "feature_map" not in aux or probe.delta is None:
            raise _no_feature_map()
        idx = _as_index(class_idx, logits.device)
        score = logits.float().gather(1, idx[:, None]).sum()
        (g,) = torch.autograd.grad(score, probe.delta)
    return aux["feature_map"].detach().float(), g.float()


def normalize_and_resize(cam: torch.Tensor, out_hw) -> torch.Tensor:
    """ReLU, min-max to [0, 1] per map, bilinear to ``out_hw``."""
    cam = cam.clamp_min(0.0)
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    cam = (cam - lo) / torch.clamp(hi - lo, min=1e-8)
    return _resize(cam, out_hw)


def _resize(maps: torch.Tensor, out_hw) -> torch.Tensor:
    """(N, h, w) → (N, H, W), bilinear, half-pixel centres, no antialias."""
    return F.interpolate(maps[:, None], size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


def grad_cam(model, image, metadata, class_idx) -> torch.Tensor:
    """Grad-CAM: weights = GAP(g); CAM = ReLU(Σ w·A)."""
    A, g = grads_and_activations(model, image, metadata, class_idx)
    w = g.mean(dim=(1, 2))  # (B, C)
    cam = torch.einsum("bhwc,bc->bhw", A, w)
    return normalize_and_resize(cam, image.shape[1:3])


def grad_cam_pp(model, image, metadata, class_idx) -> torch.Tensor:
    """Grad-CAM++: α = g² / (2g² + Σ_hw A·g³); w = Σ_hw α·ReLU(g);
    CAM = ReLU(Σ w·A)."""
    A, g = grads_and_activations(model, image, metadata, class_idx)
    g2, g3 = g * g, g * g * g
    denom = 2.0 * g2 + (A * g3).sum(dim=(1, 2), keepdim=True)
    alpha = g2 / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    w = (alpha * g.clamp_min(0.0)).sum(dim=(1, 2))  # (B, C)
    cam = torch.einsum("bhwc,bc->bhw", A, w)
    return normalize_and_resize(cam, image.shape[1:3])


def _repeat(metadata, n: int):
    """Each row of the metadata (a tensor or a dict of tensors) n times in a
    row: (B, ...) → (B·n, ...)."""
    if isinstance(metadata, dict):
        return {k: _repeat(v, n) for k, v in metadata.items()}
    return metadata.repeat_interleave(n, dim=0)


@torch.no_grad()
def score_cam(model, image, metadata, class_idx, top_k: Optional[int] = None,
              batch_channels: int = 32) -> torch.Tensor:
    """Score-CAM: each channel's activation, upsampled and min-max normed,
    masks the image; the masked images' class probabilities, softmaxed over
    the channels, weight the channels.

    The default is the exact sweep over every channel. ``top_k`` keeps the
    channels of largest activation energy Σ|A| only. The masked images go
    through the model ``batch_channels`` channels at a time: B ×
    ``batch_channels`` images a forward."""
    with cam_mode(model):
        _, aux = model(image, metadata, capture=True)
        if "feature_map" not in aux:
            raise _no_feature_map()
        A = aux["feature_map"].float()  # (B, h, w, C)
        B, h, w, C = A.shape
        out_hw = tuple(image.shape[1:3])
        idx = _as_index(class_idx, A.device)
        energy = A.abs().sum(dim=(1, 2))  # (B, C)
        k = C if top_k is None else min(top_k, C)
        top = torch.sort(energy, dim=1, descending=True, stable=True).indices[:, :k]  # (B, k)
        A_top = A.gather(3, top[:, None, None, :].expand(B, h, w, k))  # (B, h, w, k)
        scores: List[torch.Tensor] = []
        for start in range(0, k, batch_channels):
            sel = A_top[..., start:start + batch_channels]  # (B, h, w, cc)
            cc = sel.shape[-1]
            m = _resize(sel.permute(0, 3, 1, 2).reshape(B * cc, h, w), out_hw)
            lo = m.amin(dim=(1, 2), keepdim=True)
            hi = m.amax(dim=(1, 2), keepdim=True)
            m = (m - lo) / torch.clamp(hi - lo, min=1e-8)  # (B·cc, H, W)
            masked = image.repeat_interleave(cc, dim=0) * m[..., None].to(image.dtype)
            out = model(masked, _repeat(metadata, cc))
            probs = torch.softmax(out.float(), dim=-1).reshape(B, cc, -1)
            scores.append(probs.gather(2, idx[:, None, None].expand(B, cc, 1))[..., 0])
        wts = torch.softmax(torch.cat(scores, dim=1), dim=1)  # (B, k)
        cam = torch.einsum("bhwk,bk->bhw", A_top, wts)
        return normalize_and_resize(cam, out_hw)


def cam_methods_comparison(model, image, metadata, class_idx, path: str, image_u8=None,
                           score_cam_top_k: Optional[int] = None, alpha: float = 0.4
                           ) -> List[str]:
    """Side-by-side Original / Score-CAM / Grad-CAM / Grad-CAM++ panel (1×4,
    jet overlays at ``alpha``), one a sample: ``path`` gets an ``_i`` suffix
    for batches above 1. ``image_u8``: the display images (by default the
    min-max-rescaled ``image``). Returns the written paths: none, with a
    note, where matplotlib is not installed."""
    from skinjax_torch.eval.artifacts import _plt

    plt = _plt(path)
    if plt is None:
        return []
    cams: Dict[str, np.ndarray] = {
        "ScoreCAM": score_cam(model, image, metadata, class_idx, top_k=score_cam_top_k),
        "GradCAM": grad_cam(model, image, metadata, class_idx),
        "GradCAM++": grad_cam_pp(model, image, metadata, class_idx),
    }
    cams = {k: v.cpu().numpy() for k, v in cams.items()}
    if image_u8 is None:
        img = image.detach().float().cpu().numpy()
        lo, hi = img.min(), img.max()
        disp = (img - lo) / max(hi - lo, 1e-8)
    else:
        disp = np.asarray(image_u8).astype(np.float32) / 255.0
    B = image.shape[0]
    written = []
    for i in range(B):
        fig, axes = plt.subplots(1, 4, figsize=(18, 6))
        axes[0].imshow(disp[i])
        axes[0].set_title("Original Image")
        for ax, (name, cam) in zip(axes[1:], cams.items()):
            ax.imshow(disp[i])
            ax.imshow(cam[i], cmap="jet", alpha=alpha)
            ax.set_title(f"Image with {name}")
        for ax in axes:
            ax.axis("off")
        fig.tight_layout()
        out = path if B == 1 else path.replace(".png", f"_{i}.png")
        fig.savefig(out)
        plt.close(fig)
        written.append(out)
    return written


# matplotlib's ``jet`` (``matplotlib._cm._jet_data``): per channel, the
# piecewise-linear segments (x, y) it interpolates over [0, 1]
JET_SEGMENTS = {
    "red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
}
JET_N = 256


def jet_table(n: int = JET_N) -> np.ndarray:
    """(n, 3) float64: the colormap's lookup table, each segment's line
    sampled at n points in matplotlib's own arithmetic
    (``colors._create_lookup_table``)."""
    xind = (n - 1) * np.linspace(0, 1, n)
    channels = []
    for seg in JET_SEGMENTS.values():
        x = np.array([p[0] for p in seg]) * (n - 1)
        y = np.array([p[1] for p in seg])
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut = np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1]) + y[ind - 1], [y[-1]]])
        channels.append(np.clip(lut, 0.0, 1.0))
    return np.stack(channels, axis=-1)


_JET = jet_table()


def jet(cam) -> np.ndarray:
    """``matplotlib.cm.jet(cam)[..., :3]`` without matplotlib: index
    ``int(cam·256)`` (1.0 to the last entry, in cam's own float dtype), below
    0 the first colour, above 1 the last, NaN black."""
    xa = np.array(cam, copy=True)
    if xa.dtype.kind != "f":
        xa = xa.astype(np.float64)
    xa *= JET_N
    xa[xa == JET_N] = JET_N - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        index = np.clip(np.where(bad, 0, xa), -1, JET_N).astype(int)
    rgb = _JET.take(np.clip(index, 0, JET_N - 1), axis=0)
    rgb[bad] = 0.0
    return rgb


def overlay_heatmap(image_u8, cam, alpha: float = 0.4) -> np.ndarray:
    """uint8 (H, W, 3) RGB: ``(1 - alpha)·image + alpha·jet(cam)``, for the
    demo and the service; no matplotlib."""
    if isinstance(cam, torch.Tensor):
        cam = cam.detach().cpu().numpy()
    img = np.asarray(image_u8).astype(np.float32) / 255.0
    out = (1 - alpha) * img + alpha * jet(np.asarray(cam))
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
