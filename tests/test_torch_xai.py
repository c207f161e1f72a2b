"""The port's CAM path against skinjax's, in fp32 on the CPU.

The capture contract on every tower that carries ``capture``/``feature_delta``
in skinjax (ViT with CLS and with mean pooling, BEiT, MViTv2 and CoaT-lite at
``tests/test_cam_token_backbones.py``'s narrow sizes; DaViT, CAFormer and
NextViT narrow), on a narrow ResNet, whose NHWC map the multimodal model
pools, and on Swin, whose map skinjax's multimodal model pools and the
port's tower pools itself: the tower's pooled output under ``capture`` is
its default output, and through ``MultimodalModel`` the grid and
d(score)/d(delta) are skinjax's and the gradient is not zero. Then
``grad_cam``, ``grad_cam_pp`` and ``score_cam`` (exact and ``top_k``) on a
narrow ResNet model and a CLS-pool ViT model against skinjax's; the bilinear
upsampling against ``jax.image.resize``; the jet table against matplotlib's
and ``overlay_heatmap`` against skinjax's.

Weights are drawn on skinjax's parameter tree (``jax_variables``) and carried
across by ``state_dict_from_flax``; inputs are drawn with numpy. Tolerances:
the grids and gradients 1e-4 of max(1, |x|); the maps in [0, 1] 2e-3, as
``tests/test_cam_parity.py`` holds skinjax's against a PyTorch oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skinjax.models.backbones as jax_backbones
import skinjax_torch.models.backbones as port_backbones
from skinjax.models import MultimodalModel as JaxModel
from skinjax.models.backbones import beit as jbeit
from skinjax.models.backbones import caformer as jcaformer
from skinjax.models.backbones import coat as jcoat
from skinjax.models.backbones import davit as jdavit
from skinjax.models.backbones import mvit as jmvit
from skinjax.models.backbones import nextvit as jnext
from skinjax.models.backbones import resnet as jresnet
from skinjax.models.backbones import transformer_zoo as jzoo
from skinjax.models.backbones import vit as jvit
from skinjax.xai import cam as jcam
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.backbones import (
    beit,
    caformer,
    coat,
    davit,
    mvit,
    nextvit,
    resnet,
    swin,
    vit,
)
from skinjax_torch.models.backbones.capture import DeltaProbe
from skinjax_torch.models.weights import load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.xai import cam
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

NEXT_KW = dict(stem_chs=(16, 16, 32), stage_channels=((32,), (64, 128), (128,), (128,)),
               stage_types=(("ncb",), ("ncb", "ntb"), ("ntb",), ("ntb",)))
NEXT_DEPTHS = (1, 2, 1, 1)
# name: (skinjax tower, port tower, feature width, image side)
TOWERS = {
    "vit-cls": (lambda: jvit.ViT(dim=32, depth=2, num_heads=2, patch=16),
                lambda: vit.VisionTransformer(32, 2, 2, 16, img_size=32), 32, 32),
    "vit-mean": (lambda: jvit.ViT(dim=32, depth=2, num_heads=2, patch=16, pool="mean"),
                 lambda: vit.VisionTransformer(32, 2, 2, 16, img_size=32, pool="mean"), 32, 32),
    "beit": (lambda: jbeit.Beit(dim=32, depth=2, num_heads=2, patch=16),
             lambda: beit.Beit(32, 2, 2, 16, img_size=32), 32, 32),
    "mvitv2": (lambda: jmvit.MViTv2(dims=(16, 32, 48, 64), depths=(1, 1, 1, 1),
                                    heads=(1, 2, 2, 4)),
               lambda: mvit.MViTv2((16, 32, 48, 64), (1, 1, 1, 1), (1, 2, 2, 4), img_size=64),
               64, 64),
    "coat": (lambda: jcoat.CoaTLite(dims=(16, 32, 48, 64), depths=(1, 1, 1, 1)),
             lambda: coat.CoaTLite((16, 32, 48, 64), (1, 1, 1, 1)), 64, 64),
    "davit": (lambda: jdavit.DaViT((16, 32), (1, 2), (2, 4)),
              lambda: davit.DaViT((16, 32), (1, 2), (2, 4)), 32, 56),
    "caformer": (lambda: jcaformer.CAFormer(dims=(16, 32), depths=(1, 1),
                                            mixers=("conv", "attention"),
                                            res_scale_stages=(False, True)),
                 lambda: caformer.CAFormer((16, 32), (1, 1), ("conv", "attention"),
                                           (False, True)), 32, 32),
    "nextvit": (lambda: jnext.NextViT(**NEXT_KW),
                lambda: nextvit.NextViT(NEXT_DEPTHS, **NEXT_KW), 128, 64),
    "resnet": (lambda: jresnet.ResNet(stage_sizes=(1, 1), width=8),
               lambda: resnet.ResNet((1, 1), "basic", width=8), 16, 32),
    "swin": (lambda: jzoo.Swin(dims=(16, 32), depths=(2, 2), heads=(1, 2), window=4),
             lambda: swin.Swin((16, 32), (2, 2), (1, 2), window=4), 32, 32),
}
CAPTURE_IN_TOWER = ("vit-cls", "vit-mean", "beit", "mvitv2", "coat", "davit", "caformer",
                    "nextvit", "swin")
CFG = dict(num_classes=4, num_heads=2, common_dim=16, text_encoder_dim_output=16,
           vocab_size=6, attention_mechanism="concatenation")
B = 2
MAP_TOL = 2e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _register(monkeypatch, name):
    jctor, pctor, width, _ = TOWERS[name]
    tower = f"xai-{name}-test"
    monkeypatch.setitem(jax_backbones._REGISTRY, tower, (
        lambda name=None, dtype=None, common_dim=512: jctor(), width))
    monkeypatch.setitem(port_backbones._REGISTRY, tower, (lambda device=None: pctor(), width))
    return dict(CFG, cnn_model_name=tower)


def _models(monkeypatch, name, seed=0):
    """skinjax's model, its variables and the port's model on them."""
    cfg = _register(monkeypatch, name)
    side = TOWERS[name][3]
    model = JaxModel(**cfg)
    variables = jax_variables(model, (side, side), cfg["vocab_size"], seed=seed)
    sd = state_dict_from_flax(variables["params"], variables.get("batch_stats", {}),
                              nextvit_depths=NEXT_DEPTHS if name == "nextvit" else None)
    port = load_numpy_state_dict(MultimodalModel(**cfg), sd).eval()
    return model, variables, port


def _inputs(name, seed=1):
    side = TOWERS[name][3]
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, side, side, 3)).astype(np.float32)
    meta = rng.normal(size=(B, CFG["vocab_size"])).astype(np.float32)
    return img, meta, np.array([1, 3])


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-4 * max(1.0, np.abs(b).max()), rtol=0)


def _jax_grid_and_grad(model, variables, img, meta, cls, shape):
    """skinjax's grid and d(score)/d(delta), as its CAM takes them (the
    grid's shape is the port's, which the comparison checks)."""

    @jax.jit
    def run(v, d):
        def score(d):
            logits, aux = model.apply(v, img, meta, capture=True, feature_delta=d)
            return jnp.take_along_axis(logits, cls[:, None], axis=1).sum(), aux["feature_map"]

        return jax.grad(score, has_aux=True)(d)

    g, fmap = run(variables, jnp.zeros(shape, jnp.float32))
    return np.asarray(fmap), np.asarray(g)


@pytest.mark.parametrize("name", list(TOWERS))
def test_capture_contract(monkeypatch, name):
    model, variables, port = _models(monkeypatch, name)
    img, meta, cls = _inputs(name)
    x = torch.from_numpy(img)
    tower = port.image_encoder
    with torch.no_grad():
        base = tower(x)
        if name in CAPTURE_IN_TOWER:
            pooled, fmap = tower(x, capture=True)
            assert fmap.dim() == 4 and fmap.shape[1] > 1 and fmap.shape[2] > 1
            torch.testing.assert_close(pooled, base, atol=2e-5, rtol=2e-5)
        else:  # the NHWC map the multimodal model pools
            assert base.dim() == 4

    probe = DeltaProbe()
    logits, aux = port(x, torch.from_numpy(meta), capture=True, feature_delta=probe)
    score = logits.gather(1, torch.from_numpy(cls)[:, None]).sum()
    (g,) = torch.autograd.grad(score, probe.delta)
    assert set(aux) >= {"feature_map", "img_feat", "proj_img", "txt_feat", "proj_txt"}
    with torch.no_grad():
        torch.testing.assert_close(logits, port(x, torch.from_numpy(meta)), atol=1e-5,
                                   rtol=1e-5)

    fmap_ref, g_ref = _jax_grid_and_grad(model, variables, img, meta, cls, tuple(g.shape))
    _close(aux["feature_map"].detach(), fmap_ref)
    _close(g, g_ref)
    assert torch.isfinite(g).all() and g.abs().max() > 0


# skinjax's Score-CAM compiled as one program (its eager sweep compiles each
# operation on its own, slower on the CPU); the same function
_jax_score_cam = jax.jit(jcam.score_cam, static_argnames=("model", "top_k", "batch_channels"))


def _maps(model, variables, port, img, meta, cls):
    """{method: (port's maps, skinjax's maps)}."""
    ji, jm, jc = jnp.asarray(img), jnp.asarray(meta), jnp.asarray(cls)
    ti, tm = torch.from_numpy(img), torch.from_numpy(meta)
    return {
        "grad_cam": (cam.grad_cam(port, ti, tm, cls),
                     jcam.grad_cam(model, variables, ji, jm, jc)),
        "grad_cam_pp": (cam.grad_cam_pp(port, ti, tm, cls),
                        jcam.grad_cam_pp(model, variables, ji, jm, jc)),
        "score_cam": (cam.score_cam(port, ti, tm, cls, batch_channels=64),
                      _jax_score_cam(model, variables, ji, jm, jc, batch_channels=64)),
        "score_cam_top8": (cam.score_cam(port, ti, tm, cls, top_k=8, batch_channels=4),
                           _jax_score_cam(model, variables, ji, jm, jc, top_k=8,
                                          batch_channels=4)),
    }


@pytest.mark.parametrize("name", ["resnet", "vit-cls"])
def test_maps_match_skinjax(monkeypatch, name):
    """The four maps on a narrow ResNet model (a 4×4 grid of 16 channels) and
    a CLS-pool ViT model (a 2×2 grid of 32): (B, H, W) in [0, 1], within
    2e-3 of skinjax's; the parameters' flags restored and no ``.grad``."""
    model, variables, port = _models(monkeypatch, name, seed=4)
    img, meta, cls = _inputs(name, seed=5)
    for method, (ours, ref) in _maps(model, variables, port, img, meta, cls).items():
        assert ours.shape == (B, *img.shape[1:3]) and ours.dtype == torch.float32, method
        assert 0.0 <= float(ours.min()) and float(ours.max()) <= 1.0, method
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=MAP_TOL, rtol=0,
                                   err_msg=method)
    assert all(p.requires_grad and p.grad is None for p in port.parameters())
    assert not port.training


def test_cam_needs_a_grid(monkeypatch):
    """A tower with neither the kwargs nor a map (custom-cnn) is refused, as
    skinjax refuses it."""
    port = MultimodalModel(**dict(CFG, cnn_model_name="custom-cnn")).eval()
    x, meta = torch.zeros(1, 32, 32, 3), torch.zeros(1, CFG["vocab_size"])
    for fn in (cam.grad_cam, cam.score_cam):
        with pytest.raises(ValueError, match="no spatial feature map"):
            fn(port, x, meta, [0])


@pytest.mark.parametrize("src,dst", [((7, 7), (224, 224)), ((4, 3), (32, 40)), ((2, 2), (32, 32))])
def test_upsampling_matches_jax_resize(src, dst):
    """F.interpolate (bilinear, half-pixel, no antialias) is
    ``jax.image.resize(..., "bilinear")`` when it enlarges, borders
    included, within 1e-6."""
    x = np.random.default_rng(0).random((3, *src)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, *dst), method="bilinear"))
    np.testing.assert_allclose(cam._resize(torch.from_numpy(x), dst).numpy(), ref, atol=1e-6)


def test_jet_table_and_overlay_match_matplotlib_and_skinjax():
    """The port's jet table is matplotlib's within 1 LSB (of 255); the
    overlay is skinjax's ``overlay_heatmap`` bit for bit, 0 and 1 and the
    bin edges included."""
    import matplotlib

    mpl = matplotlib.colormaps["jet"]
    assert np.abs(cam.jet_table() - mpl(np.arange(256))[:, :3]).max() * 255 <= 1.0
    rng = np.random.default_rng(0)
    heat = rng.random((40, 48)).astype(np.float32)
    heat[0, :5] = [0.0, 1.0, 0.5, 255 / 256, 1 / 256]
    img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
    np.testing.assert_array_equal(cam.jet(heat), mpl(heat)[..., :3])
    np.testing.assert_array_equal(cam.overlay_heatmap(img, torch.from_numpy(heat)),
                                  jcam.overlay_heatmap(img, heat))
