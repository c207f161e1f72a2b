"""NextViT, the official layout under timm's ``stages.{si}.{bi}`` names
(counterpart of ``skinjax/models/backbones/nextvit.py``).

4-conv BN+ReLU stem (3→64/s2→32→64→64/s2) → per-stage blocks: NCB
(PatchEmbed → MHCA residual → BN → 1×1-conv MLP residual, hidden
make_divisible(3C)) and NTB (PatchEmbed → BN → E-MHSA on a
make_divisible(0.75·C) channel slice, its K/V tokens avg-pooled by sr² and
BatchNorm'd → PatchEmbed to the other channels → MHCA residual → channel
concat → BN → MLP residual, hidden make_divisible(2C)) → BatchNorm → mean
over the map. ``nextvit_small``'s plan: [96×3], [192×3, 256], [384×4, 512]×2,
[768×2, 1024]; 1024 features.

Parameter names are the keys ``skinjax.models.torch_import.import_nextvit``
reads: ``stem.{i}.{conv,norm}``, ``stages.{si}.{bi}.{patch_embed.{conv,norm},
mhca.{group_conv3x3,norm,projection}, norm, norm1, e_mhsa.{q,k,v,proj,norm},
projection.{conv,norm}, norm2, mlp.{conv1,conv2}}``, ``norm`` (created last,
so the freeze policy's "last layer" is the final BatchNorm, as in skinjax).
The MLPs are 1×1 convs with bias (timm's 4-D weights), E-MHSA's projections
linears.

Layout: input NHWC ``(B, H, W, 3)``; inside, NCHW views with channels_last
strides (as the ResNet), so every BatchNorm on the card sees rows of C
contiguous channels; E-MHSA works on the (B, N, C) tokens of that map (a
view), and its pooled tokens' ``BatchNorm1d`` on their (B, C, Np) view.
Output ``(B, 1024)``: the normed map's mean. CAM (``capture``/
``feature_delta``, ``backbones/capture.py``): the grid is the normed map, as
NHWC, before the mean, as in skinjax.

E-MHSA's attention is plain: fp32 scores of the (autocast-dtype) q and k,
scaled, an fp32 softmax cast to q's dtype, times v, as skinjax's einsums
(its Nq ≠ Nk where it pools, so it is not a K12 call). The BatchNorms are
``ops.batch_norm.BatchNorm2d``/``BatchNorm1d``; ``fuse_batch_norms`` sends
them through K6.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from skinjax_torch.models.backbones.capture import add_delta
from skinjax_torch.ops.batch_norm import BatchNorm1d, BatchNorm2d

FEATURE_DIM = 1024


def make_divisible(v: float, divisor: int = 32) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def nextvit_plan(depths: Sequence[int] = (3, 4, 10, 3)) -> Tuple[list, list]:
    """The official stage_out_channels / block-type tables (a copy of
    skinjax's)."""
    chans = [
        [96] * depths[0],
        [192] * (depths[1] - 1) + [256],
        [384, 384, 384, 384, 512] * (depths[2] // 5),
        [768] * (depths[3] - 1) + [1024],
    ]
    types = [
        ["ncb"] * depths[0],
        ["ncb"] * (depths[1] - 1) + ["ntb"],
        (["ncb"] * 4 + ["ntb"]) * (depths[2] // 5),
        ["ncb"] * (depths[3] - 1) + ["ntb"],
    ]
    return chans, types


def _bn(c: int, *, device=None) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, device=device)


def _conv1x1(cin: int, cout: int, bias: bool = False, *, device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, bias=bias, device=device)


class ConvNormAct(nn.Module):
    """3×3 conv → BatchNorm → ReLU (a stem layer)."""

    def __init__(self, cin: int, cout: int, stride: int, *, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False, device=device)
        self.norm = _bn(cout, device=device)

    def forward(self, x):
        return torch.relu(self.norm(self.conv(x)))


class NextPatchEmbed(nn.Module):
    """avg-pool 2×2 + 1×1 conv + BN when strided; 1×1 conv + BN on a width
    change; the identity otherwise (no parameters)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, *, device=None):
        super().__init__()
        self.stride = stride
        self.identity = stride == 1 and cin == cout
        if not self.identity:
            self.conv = _conv1x1(cin, cout, device=device)
            self.norm = _bn(cout, device=device)

    def forward(self, x):
        if self.identity:
            return x
        if self.stride == 2:
            x = nn.functional.avg_pool2d(x, 2, 2)
        return self.norm(self.conv(x))


class MHCA(nn.Module):
    """Multi-head convolutional attention: grouped 3×3 (head_dim channels a
    group) → BN → ReLU → 1×1."""

    def __init__(self, dim: int, head_dim: int = 32, *, device=None):
        super().__init__()
        self.group_conv3x3 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim // head_dim,
                                       bias=False, device=device)
        self.norm = _bn(dim, device=device)
        self.projection = _conv1x1(dim, dim, device=device)

    def forward(self, x):
        return self.projection(torch.relu(self.norm(self.group_conv3x3(x))))


class NextMlp(nn.Module):
    """1×1 conv → ReLU → 1×1 conv, both with bias."""

    def __init__(self, dim: int, hidden: int, *, device=None):
        super().__init__()
        self.conv1 = _conv1x1(dim, hidden, bias=True, device=device)
        self.conv2 = _conv1x1(hidden, dim, bias=True, device=device)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class EMHSA(nn.Module):
    """Efficient MHSA on (B, N, C) tokens: K/V from the tokens avg-pooled in
    consecutive groups of sr² (a ragged tail dropped), BatchNorm'd over
    their channels."""

    def __init__(self, dim: int, head_dim: int = 32, sr_ratio: int = 1, *, device=None):
        super().__init__()
        self.heads, self.head_dim, self.sr_ratio = dim // head_dim, head_dim, sr_ratio
        self.q = nn.Linear(dim, dim, device=device)
        self.k = nn.Linear(dim, dim, device=device)
        self.v = nn.Linear(dim, dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        if sr_ratio > 1:
            self.norm = BatchNorm1d(dim, eps=1e-5, device=device)

    def _heads(self, t):
        B, N, _ = t.shape
        return t.reshape(B, N, self.heads, self.head_dim).transpose(1, 2)

    def forward(self, x):
        B, N, C = x.shape
        q = self._heads(self.q(x))
        kv = x
        if self.sr_ratio > 1:
            pool = self.sr_ratio ** 2
            kv = x[:, :N // pool * pool].reshape(B, N // pool, pool, C).mean(dim=2)
            kv = self.norm(kv.transpose(1, 2)).transpose(1, 2)
        k, v = self._heads(self.k(kv)), self._heads(self.v(kv))
        with torch.autocast(x.device.type, enabled=False):
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.head_dim ** -0.5
            attn = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class NCB(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1, head_dim: int = 32, div: int = 32,
                 *, device=None):
        super().__init__()
        self.patch_embed = NextPatchEmbed(cin, cout, stride, device=device)
        self.mhca = MHCA(cout, head_dim, device=device)
        self.norm = _bn(cout, device=device)
        self.mlp = NextMlp(cout, make_divisible(cout * 3, div), device=device)

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.mhca(x)
        return x + self.mlp(self.norm(x))


class NTB(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1, sr_ratio: int = 1,
                 head_dim: int = 32, div: int = 32, mix_ratio: float = 0.75, *, device=None):
        super().__init__()
        mhsa_ch = make_divisible(int(cout * mix_ratio), div)
        mhca_ch = cout - mhsa_ch
        self.patch_embed = NextPatchEmbed(cin, mhsa_ch, stride, device=device)
        self.norm1 = _bn(mhsa_ch, device=device)
        self.e_mhsa = EMHSA(mhsa_ch, head_dim, sr_ratio, device=device)
        self.projection = NextPatchEmbed(mhsa_ch, mhca_ch, 1, device=device)
        self.mhca = MHCA(mhca_ch, head_dim, device=device)
        self.norm2 = _bn(cout, device=device)
        self.mlp = NextMlp(cout, make_divisible(cout * 2, div), device=device)

    def forward(self, x):
        x = self.patch_embed(x)
        B, C, H, W = x.shape
        tokens = self.norm1(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        x = x + self.e_mhsa(tokens).reshape(B, H, W, C).permute(0, 3, 1, 2)
        out = self.projection(x)
        out = out + self.mhca(out)
        x = torch.cat([x, out], dim=1)
        return x + self.mlp(self.norm2(x))


class NextViT(nn.Module):
    """The official topology; ``stage_channels``/``stage_types`` override the
    plan (the tests' narrow towers)."""

    def __init__(self, depths: Sequence[int] = (3, 4, 10, 3),
                 stem_chs: Sequence[int] = (64, 32, 64), sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 head_dim: int = 32, div: int = 32,
                 stage_channels: Optional[Sequence[Sequence[int]]] = None,
                 stage_types: Optional[Sequence[Sequence[str]]] = None, *, device=None):
        super().__init__()
        chans, types = nextvit_plan(depths)
        if stage_channels is not None:
            chans = [list(c) for c in stage_channels]
        if stage_types is not None:
            types = [list(t) for t in stage_types]
        plan = [(3, stem_chs[0], 2), (stem_chs[0], stem_chs[1], 1),
                (stem_chs[1], stem_chs[2], 1), (stem_chs[2], stem_chs[2], 2)]
        self.stem = nn.Sequential(*[ConvNormAct(a, b, s, device=device) for a, b, s in plan])
        cin = stem_chs[2]
        stages: List[nn.Module] = []
        for si, (stage_ch, stage_ty) in enumerate(zip(chans, types)):
            blocks = []
            for bi, (ch, ty) in enumerate(zip(stage_ch, stage_ty)):
                stride = 2 if (bi == 0 and si > 0) else 1
                if ty == "ncb":
                    blocks.append(NCB(cin, ch, stride, head_dim, div, device=device))
                else:
                    blocks.append(NTB(cin, ch, stride, sr_ratios[si], head_dim, div,
                                      device=device))
                cin = ch
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)
        self.norm = _bn(cin, device=device)

    def forward(self, x: torch.Tensor, capture: bool = False, feature_delta=None):
        """x: (B, H, W, 3) NHWC → (B, C) features; with ``capture`` also the
        normed map (B, h, w, C), the CAM grid (``backbones/capture.py``)."""
        x = self.stem(x.permute(0, 3, 1, 2))
        for stage in self.stages:
            x = stage(x)
        x = self.norm(x)
        if not capture and feature_delta is None:
            return x.mean(dim=(2, 3))
        grid = add_delta(x.permute(0, 2, 3, 1), feature_delta)
        pooled = grid.mean(dim=(1, 2))
        return (pooled, grid) if capture else pooled

    def flax_scopes(self) -> Iterator[Tuple[str, str]]:
        """(parameter-name prefix, skinjax scope) pairs: the key map of
        ``state_dict_from_flax``, which the freeze policy reads."""
        for i in range(len(self.stem)):
            yield f"stem.{i}.conv.", f"stem{i}_conv"
            yield f"stem.{i}.norm.", f"stem{i}_norm"
        idx = 0
        for si, stage in enumerate(self.stages):
            for bi in range(len(stage)):
                yield f"stages.{si}.{bi}.", f"b{idx}"
                idx += 1
        yield "norm.", "norm"


def nextvit_small(*, device=None) -> NextViT:
    return NextViT((3, 4, 10, 3), device=device)
