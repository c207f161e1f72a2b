"""The masked, shape-static supernet (counterpart of ``skinjax/nas/supernet.py``):
every candidate of a population runs as one module, its architecture carried
as data (mask tensors), so ``torch.func.vmap`` over (parameters, masks)
trains K candidates with one forward and one backward
(``nas/population.py``).

The exactness recipe is skinjax's, and a candidate embedded with
``embed_params`` reproduces its own ``DynamicCNN``'s forward and its live
parameters' gradients:

- channels embed *group-aligned*: candidate group g fills the prefix of
  supernet group g, and the masked GroupNorm takes its statistics over the
  active channels only, in float32, with a guard for the all-zero masks of
  blocks past the candidate's depth;
- kernel size 3 is the centre taps of the 5×5 kernel (padding ``ks // 2``);
- ``layers_per_block`` 1 skips the second conv of a block by the identity
  bypass ``m·f(x) + (1 − m)·x``, and the text and fc layer counts likewise;
- ``block_sel`` picks the candidate's last block from the per-block global
  averages, zero-padded to ``FEAT_PAD``;
- the crossattention/gfcam branches are the seq-1 attention collapse
  ``out_proj(v_proj(kv))``, so they mask as prefixes; metablock's LayerNorms
  are masked LayerNorms over the active image channels.

``Envelope``, ``envelope_of`` and ``candidate_masks`` are numpy, copied from
skinjax so that the masks are the same arrays. Images come in NHWC; a bf16
image meets float32 kernels in float32, as flax promotes it. Dropout (rate
0.3, after each classifier layer) takes its keep masks as an argument, drawn
by the caller, so a candidate's draws do not depend on its place in a
bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.models.fusion.blocks import LN_EPS
from skinjax_torch.nas.dynamic_model import GN_EPS, MECHANISMS
from skinjax_torch.nas.search_space import filters_from_config

FEAT_PAD = 512  # == the filter cap in search_space.filters_from_config
GN_GROUPS = 8  # min(8, C) == 8 for every C in the space (all C >= 8)
DROPOUT_RATE = 0.3


def _filters(num_blocks: int, initial_filters: int) -> List[int]:
    return filters_from_config(
        {"num_blocks": num_blocks, "initial_filters": initial_filters}
    )


@dataclasses.dataclass(frozen=True)
class Envelope:
    """Static shape envelope of a candidate population.

    ``use_pooling`` must be uniform across the population (pooling changes
    spatial shapes and cannot be emulated by masking); the population
    scheduler buckets on it.
    """

    num_blocks: int
    initial_filters: int
    kernel_size: int
    layers_per_block: int
    use_pooling: bool
    text_width: int
    text_layers: int
    common_dim: int
    fc_width: int
    fc_layers: int
    mechanisms: Tuple[str, ...]


def envelope_of(configs: Sequence[Dict]) -> Envelope:
    cs = [dict(c) for c in configs]
    pooling = {bool(c.get("use_pooling", True)) for c in cs}
    if len(pooling) != 1:
        raise ValueError(
            "population mixes use_pooling True/False — bucket by pooling first"
        )
    mx = lambda k: max(int(c[k]) for c in cs)
    return Envelope(
        num_blocks=mx("num_blocks"),
        initial_filters=mx("initial_filters"),
        kernel_size=mx("kernel_size"),
        layers_per_block=mx("layers_per_block"),
        use_pooling=pooling.pop(),
        text_width=mx("neurons_per_layer_size_of_text_fc"),
        text_layers=mx("num_layers_text_fc"),
        common_dim=mx("common_dim"),
        fc_width=mx("neurons_per_layer_size_of_fc_module"),
        fc_layers=mx("num_layers_fc_module"),
        mechanisms=tuple(sorted({c["attention_mecanism"] for c in cs})),
    )


def _prefix(n_total: int, n_active: int) -> np.ndarray:
    m = np.zeros(n_total, np.float32)
    m[:n_active] = 1.0
    return m


def _group_aligned(c_sup: int, c_cand: int) -> np.ndarray:
    """Channel mask where candidate group g fills the prefix of supernet
    group g (GroupNorm groups are contiguous channel slices)."""
    m = np.zeros(c_sup, np.float32)
    gs, ge = c_sup // GN_GROUPS, c_cand // GN_GROUPS
    for g in range(GN_GROUPS):
        m[g * gs : g * gs + ge] = 1.0
    return m


def candidate_masks(config: Dict, env: Envelope) -> Dict[str, np.ndarray]:
    """Compile a candidate config into the mask arrays for ``env``."""
    cfg = dict(config)
    nb = int(cfg["num_blocks"])
    f0 = int(cfg["initial_filters"])
    k = int(cfg["kernel_size"])
    if bool(cfg.get("use_pooling", True)) != env.use_pooling:
        raise ValueError("candidate use_pooling does not match envelope")
    sup_f = _filters(env.num_blocks, env.initial_filters)
    cand_f = _filters(nb, f0)

    m: Dict[str, np.ndarray] = {}
    for bi in range(env.num_blocks):
        m[f"conv_ch_{bi}"] = (
            _group_aligned(sup_f[bi], cand_f[bi])
            if bi < nb
            else np.zeros(sup_f[bi], np.float32)
        )
    km = np.zeros((env.kernel_size, env.kernel_size), np.float32)
    o = (env.kernel_size - k) // 2
    km[o : o + k, o : o + k] = 1.0
    m["kernel"] = km
    m["layer2"] = np.float32(1.0 if int(cfg["layers_per_block"]) >= 2 else 0.0)
    sel = np.zeros(env.num_blocks, np.float32)
    sel[nb - 1] = 1.0
    m["block_sel"] = sel
    imf = np.zeros(FEAT_PAD, np.float32)
    imf[: sup_f[nb - 1]] = m[f"conv_ch_{nb - 1}"]
    m["img_feat"] = imf
    m["text_w"] = _prefix(
        env.text_width, int(cfg["neurons_per_layer_size_of_text_fc"])
    )
    m["text_layer"] = np.array(
        [1.0 if i < int(cfg["num_layers_text_fc"]) else 0.0
         for i in range(env.text_layers)],
        np.float32,
    )
    m["common"] = _prefix(env.common_dim, int(cfg["common_dim"]))
    mech = np.zeros(len(env.mechanisms), np.float32)
    mech[env.mechanisms.index(cfg["attention_mecanism"])] = 1.0
    m["mech"] = mech
    m["fc_w"] = _prefix(
        env.fc_width, int(cfg["neurons_per_layer_size_of_fc_module"])
    )
    m["fc_layer2"] = np.float32(
        1.0 if int(cfg["num_layers_fc_module"]) >= 2 else 0.0
    )
    return m


def dropout_sites(env: Envelope) -> Tuple[str, ...]:
    """The classifier layers that drop their output in train mode."""
    return ("fc0", "fc1") if env.fc_layers >= 2 else ("fc0",)


def masked_group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """ReLU of GroupNorm(8) of an NCHW map, with the statistics over the
    channels ``mask`` keeps, in float32 (skinjax's ``masked_gn``). The
    centred map is formed with the mask applied and the scale is folded into
    the reciprocal deviation, which changes nothing the (masked) output keeps
    beyond the last bit and lets autograd save two maps a layer (the centred
    map and the ReLU's output), not four: at a population's widths the saved
    maps are most of a step's device memory."""
    B, C, H, W = y.shape
    G = GN_GROUPS
    xg = y.float().reshape(B, G, C // G, H, W)
    mg = mask.reshape(G, C // G)
    cnt = torch.clamp(mg.sum(-1) * (H * W), min=1.0)  # (G,)
    mg = mg[:, :, None, None]
    mean = (xg * mg).sum(dim=(2, 3, 4)) / cnt  # (B, G)
    d = (xg - mean[:, :, None, None, None]) * mg
    var = (d * d).sum(dim=(2, 3, 4)) / cnt
    mult = torch.rsqrt(var + GN_EPS)[:, :, None] * scale.reshape(G, C // G)  # (B, G, C/G)
    out = (d * mult[..., None, None]).reshape(B, C, H, W).to(y.dtype)
    return torch.relu((out + bias[:, None, None]) * mask[:, None, None])


def masked_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """LayerNorm(LN_EPS) over the positions of the last axis ``mask`` keeps."""
    cnt = torch.clamp(mask.sum(), min=1.0)
    xf = x.float()
    mean = (xf * mask).sum(-1, keepdim=True) / cnt
    d = (xf - mean) * mask
    var = (d * d).sum(-1, keepdim=True) / cnt
    y = (d * torch.rsqrt(var + LN_EPS)).to(x.dtype)
    return (y * scale + bias) * mask


class SuperNet(nn.Module):
    """Masked shape-static DynamicCNN: the architecture arrives as the
    ``masks`` argument, so one module serves every candidate inside its
    ``Envelope`` and ``torch.func.vmap`` batches candidates.

    Parameters keep skinjax's names: the raw conv kernels ``conv{b}_{l}``
    (OIHW), the GroupNorm and masked-LayerNorm affines ``gn{b}_{l}_scale`` /
    ``_bias`` and ``mb_{fb,gb}_norm_scale`` / ``_bias``, and a Linear for each
    Dense."""

    def __init__(self, env: Envelope, num_classes: int = 6, vocab_size: int = 85,
                 text_encoder_dim_output: int = 512):
        super().__init__()
        for b in env.mechanisms:
            if b not in MECHANISMS:
                raise ValueError(f"unknown fusion '{b}' for SuperNet")
        self.env = env
        ks = env.kernel_size
        c_in = 3
        for bi, c in enumerate(_filters(env.num_blocks, env.initial_filters)):
            for li in range(2 if env.layers_per_block >= 2 else 1):
                self.register_parameter(f"conv{bi}_{li}",
                                        nn.Parameter(torch.empty(c, c_in, ks, ks)))
                self.register_parameter(f"gn{bi}_{li}_scale", nn.Parameter(torch.ones(c)))
                self.register_parameter(f"gn{bi}_{li}_bias", nn.Parameter(torch.zeros(c)))
                c_in = c

        tw, cd, d_out = env.text_width, env.common_dim, text_encoder_dim_output
        self.text_in = nn.Linear(vocab_size, tw)
        for i in range(env.text_layers):
            self.add_module(f"text_h{i}", nn.Linear(tw, tw))
        self.text_out = nn.Linear(tw, d_out)
        mechs = set(env.mechanisms)
        if mechs - {"metablock"}:
            self.img_proj = nn.Linear(FEAT_PAD, cd)
            self.txt_proj = nn.Linear(d_out, cd)
        if mechs & {"crossattention", "gfcam"}:
            for side in ("img", "txt"):
                self.add_module(f"{side}_cross_v", nn.Linear(cd, cd))
                self.add_module(f"{side}_cross_out", nn.Linear(cd, cd))
        if "gfcam" in mechs:
            self.img_gate = nn.Linear(cd, cd)
            self.txt_gate = nn.Linear(cd, cd)
        if "metablock" in mechs:
            for name in ("mb_fb", "mb_gb"):
                self.add_module(name, nn.Linear(d_out, FEAT_PAD))
                self.register_parameter(f"{name}_norm_scale", nn.Parameter(torch.ones(FEAT_PAD)))
                self.register_parameter(f"{name}_norm_bias", nn.Parameter(torch.zeros(FEAT_PAD)))
        self.branch_dim = max(FEAT_PAD if b == "metablock" else 2 * cd for b in env.mechanisms)
        self.fc0 = nn.Linear(self.branch_dim, env.fc_width)
        if env.fc_layers >= 2:
            self.fc1 = nn.Linear(env.fc_width, env.fc_width)
        self.fc_out = nn.Linear(env.fc_width, num_classes)

    def _conv_gn_relu(self, bi: int, li: int, x, kmask, masks):
        w = getattr(self, f"conv{bi}_{li}")
        ks = self.env.kernel_size
        y = F.conv2d(x, (w * kmask).to(x.dtype), padding=ks // 2)
        return masked_group_norm(y, getattr(self, f"gn{bi}_{li}_scale"),
                                 getattr(self, f"gn{bi}_{li}_bias"), masks[f"conv_ch_{bi}"])

    def forward(self, image, metadata, masks: Mapping[str, torch.Tensor],
                keep: Optional[Mapping[str, torch.Tensor]] = None):
        """image (B, H, W, 3); metadata (B, V); ``masks`` one candidate's
        ``candidate_masks`` as tensors; ``keep`` the dropout keep masks
        (boolean, (B, fc_width)) of each ``dropout_sites`` layer in train
        mode, None in eval mode. Returns the logits (B, num_classes)."""
        env = self.env
        kmask = masks["kernel"]
        x = image.permute(0, 3, 1, 2)
        x = x.to(torch.promote_types(x.dtype, self.conv0_0.dtype))
        feats = []
        for bi in range(env.num_blocks):
            x = self._conv_gn_relu(bi, 0, x, kmask, masks)
            if env.layers_per_block >= 2:
                a = masks["layer2"]
                x = a * self._conv_gn_relu(bi, 1, x, kmask, masks) + (1.0 - a) * x
            if env.use_pooling and min(x.shape[2], x.shape[3]) >= 2:
                x = F.max_pool2d(x, 2)
            g = x.mean(dim=(2, 3))
            feats.append(F.pad(g, (0, FEAT_PAD - g.shape[-1])))
        img_feat = torch.einsum("n,nbc->bc", masks["block_sel"], torch.stack(feats))
        imf_mask = masks["img_feat"]

        tw = masks["text_w"]
        t = torch.relu(self.text_in(metadata) * tw)
        for i in range(env.text_layers):
            a = masks["text_layer"][i]
            t = a * torch.relu(getattr(self, f"text_h{i}")(t) * tw) + (1.0 - a) * t
        txt_feat = self.text_out(t)

        cm = masks["common"]
        mechs = set(env.mechanisms)
        if mechs - {"metablock"}:
            pi = self.img_proj(img_feat) * cm
            pt = self.txt_proj(txt_feat) * cm
        if mechs & {"crossattention", "gfcam"}:
            i_x0 = self.img_cross_out(self.img_cross_v(pt)) * cm
            t_x0 = self.txt_cross_out(self.txt_cross_v(pi)) * cm
        branches = []
        for b in env.mechanisms:
            if b == "concatenation":
                f = torch.cat([pi, pt], dim=-1)
            elif b == "crossattention":
                f = torch.cat([i_x0, t_x0], dim=-1)
            elif b == "gfcam":
                a_i = torch.sigmoid(self.img_gate(i_x0))
                a_t = torch.sigmoid(self.txt_gate(t_x0))
                f = torch.cat([a_i * i_x0, a_t * t_x0], dim=-1)
            else:  # metablock
                t1 = masked_layer_norm(self.mb_fb(txt_feat), self.mb_fb_norm_scale,
                                       self.mb_fb_norm_bias, imf_mask)
                t2 = masked_layer_norm(self.mb_gb(txt_feat), self.mb_gb_norm_scale,
                                       self.mb_gb_norm_bias, imf_mask)
                f = torch.sigmoid(torch.tanh(img_feat * t1) + t2) * imf_mask
            branches.append(F.pad(f, (0, self.branch_dim - f.shape[-1])))
        onehot = masks["mech"]
        fused = sum(onehot[j] * branches[j] for j in range(len(branches)))

        def drop(name, h):
            if keep is None:
                return h
            return torch.where(keep[name], h / (1.0 - DROPOUT_RATE), torch.zeros_like(h))

        fw = masks["fc_w"]
        h = drop("fc0", torch.relu(self.fc0(fused) * fw))
        if env.fc_layers >= 2:
            a = masks["fc_layer2"]
            y = drop("fc1", torch.relu(self.fc1(h) * fw))
            h = a * y + (1.0 - a) * h
        return self.fc_out(h)


# ---------------------------------------------------------------------------
# Candidate -> supernet parameter embedding (parity tests + exact_init)
# ---------------------------------------------------------------------------


def embed_params(cand_params: Mapping, sup_params: Mapping, config: Dict,
                 env: Envelope) -> Dict[str, torch.Tensor]:
    """Scatter a candidate ``DynamicCNN``'s state_dict into a ``SuperNet``
    state_dict for ``env``.

    The returned state_dict, run through the supernet with this candidate's
    masks, reproduces the candidate's forward and (active-parameter)
    gradients exactly. Inactive entries keep the supernet's values: they
    are dead by construction. Values may be tensors or numpy arrays; the
    result is CPU tensors.
    """
    cfg = dict(config)
    nb = int(cfg["num_blocks"])
    f0 = int(cfg["initial_filters"])
    k = int(cfg["kernel_size"])
    lpb = int(cfg["layers_per_block"])
    cd = int(cfg["common_dim"])
    ntext = int(cfg["neurons_per_layer_size_of_text_fc"])
    ltext = int(cfg["num_layers_text_fc"])
    nfc = int(cfg["neurons_per_layer_size_of_fc_module"])
    lfc = int(cfg["num_layers_fc_module"])
    mech = cfg["attention_mecanism"]

    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    sup = {n: host(v).copy() for n, v in sup_params.items()}
    cand = {n: host(v) for n, v in cand_params.items()}
    sup_f = _filters(env.num_blocks, env.initial_filters)
    cand_f = _filters(nb, f0)
    ko = (env.kernel_size - k) // 2
    ksl = list(range(ko, ko + k))

    act = {
        bi: np.where(_group_aligned(sup_f[bi], cand_f[bi]) > 0)[0]
        for bi in range(nb)
    }

    prev = np.arange(3)  # RGB input channels
    for bi in range(nb):
        for li in range(lpb):
            in_act = prev if li == 0 else act[bi]
            sup[f"conv{bi}_{li}"][np.ix_(act[bi], in_act, ksl, ksl)] = cand[
                f"conv{bi}_{li}.weight"]
            sup[f"gn{bi}_{li}_scale"][act[bi]] = cand[f"gn{bi}_{li}.weight"]
            sup[f"gn{bi}_{li}_bias"][act[bi]] = cand[f"gn{bi}_{li}.bias"]
        prev = act[bi]

    def put(weight, bias, sname, in_act, out_act):
        sup[f"{sname}.weight"][np.ix_(out_act, in_act)] = weight
        sup[f"{sname}.bias"][out_act] = bias

    def put_linear(cname, sname, in_act, out_act):
        put(cand[f"{cname}.weight"], cand[f"{cname}.bias"], sname, in_act, out_act)

    full = lambda n: np.arange(n)
    tw_act = full(ntext)
    put_linear("text_in", "text_in", full(cand["text_in.weight"].shape[1]), tw_act)
    for i in range(ltext):
        put_linear(f"text_h{i}", f"text_h{i}", tw_act, tw_act)
    put_linear("text_out", "text_out", tw_act, full(cand["text_out.weight"].shape[0]))

    imf_act = np.where(
        np.concatenate([
            _group_aligned(sup_f[nb - 1], cand_f[nb - 1]),
            np.zeros(FEAT_PAD - sup_f[nb - 1], np.float32),
        ]) > 0
    )[0]
    cd_act = full(cd)
    d_out = cand["text_out.weight"].shape[0]

    if mech == "metablock":
        put_linear("meta_block.fb.0", "mb_fb", full(d_out), imf_act)
        put_linear("meta_block.gb.0", "mb_gb", full(d_out), imf_act)
        for cn, sn in (("fb", "mb_fb_norm"), ("gb", "mb_gb_norm")):
            sup[f"{sn}_scale"][imf_act] = cand[f"meta_block.{cn}.1.weight"]
            sup[f"{sn}_bias"][imf_act] = cand[f"meta_block.{cn}.1.bias"]
        fc_in_act = imf_act
    else:
        put_linear("img_proj", "img_proj", imf_act, cd_act)
        put_linear("txt_proj", "txt_proj", full(d_out), cd_act)
        if mech in ("crossattention", "gfcam"):
            for side in ("img", "txt"):
                w, b = cand[f"{side}_cross.in_proj_weight"], cand[f"{side}_cross.in_proj_bias"]
                put(w[2 * cd:], b[2 * cd:], f"{side}_cross_v", cd_act, cd_act)
                put_linear(f"{side}_cross.out_proj", f"{side}_cross_out", cd_act, cd_act)
            if mech == "gfcam":
                put_linear("img_gate", "img_gate", cd_act, cd_act)
                put_linear("txt_gate", "txt_gate", cd_act, cd_act)
        # candidate fc0 input layout: [img(cd) | txt(cd)]; supernet layout:
        # [img(common_dim_env) | txt(common_dim_env)]
        fc_in_act = np.concatenate([cd_act, env.common_dim + cd_act])

    fw_act = full(nfc)
    put_linear("fc0", "fc0", fc_in_act, fw_act)
    if lfc >= 2:
        put_linear("fc1", "fc1", fw_act, fw_act)
    put_linear("fc_out", "fc_out", fw_act, full(cand["fc_out.weight"].shape[0]))
    return {n: torch.from_numpy(v) for n, v in sup.items()}
