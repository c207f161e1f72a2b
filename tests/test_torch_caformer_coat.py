"""The port's CAFormer and CoaT-lite towers against skinjax: a small CAFormer
(dims (16, 32), depths (1, 1), a SepConv stage and an attention stage with
residual scaling) and a small CoaT-lite (dims (16, 32), depths (1, 1), 8
heads, MLP ratio 2) through ``state_dict_from_flax`` and back through
``import_caformer``/``import_coat``; the multimodal model (RG-ATT) around
each, forward in fp32 against skinjax's default route and its all-kernel
route (``SKINJAX_CAFORMER_MLP``/``SKINJAX_COAT_MLP=all``, the Pallas MLP in
interpret mode); two Adam steps against skinjax's own train step (the
concatenation head); the freeze policy's trainable sets on the published
towers; their parameter counts and key sets; and ``state_dict_from_flax``'s
dispatch on each tree's own markers, every family. The small towers are
registered under test names in both backbone registries for the length of
each test only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import skinjax.models.backbones as jax_backbones
import skinjax_torch.models.backbones as port_backbones
from skinjax.models import MultimodalModel as JaxModel
from skinjax.models import torch_import
from skinjax.models.backbones import beit as jax_beit
from skinjax.models.backbones import caformer as jax_caformer
from skinjax.models.backbones import coat as jax_coat
from skinjax.models.backbones import davit as jax_davit
from skinjax.models.backbones import mvit as jax_mvit
from skinjax.models.backbones import resnet as jax_resnet
from skinjax.models.backbones import transformer_zoo as jax_zoo
from skinjax.models.backbones import vit as jax_vit
from skinjax.models.torch_import import import_caformer, import_coat
from skinjax.train import steps as jsteps
from skinjax.train.optimizer import make_optimizer as jax_make_optimizer
from skinjax.train.optimizer import trainable_mask as jax_trainable_mask
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.backbones import (
    beit,
    caformer,
    coat,
    create_backbone,
    davit,
    mvit,
    resnet,
    swin,
    vit,
)
from skinjax_torch.models.weights import init_weights, load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import fused_mlp as fm
from skinjax_torch.ops import global_attention as tga
from skinjax_torch.train.loop import TrainConfig, build_state
from skinjax_torch.train.optimizer import FREEZE_MODES, trainable_mask
from skinjax_torch.train.steps import make_train_step_weighted
from tests.test_torch_davit import _perturbed, _to_jax
from tests.test_torch_train import _assert_adam_close, _leaves, jax_without_dropout  # noqa: F401
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

HW = 32
RGATT = "att-intramodal+residual+cross-attention-metadados"
CA_KW = dict(dims=(16, 32), depths=(1, 1), mixers=("conv", "attention"),
             res_scale_stages=(False, True))
COAT_KW = dict(dims=(16, 32), depths=(1, 1), heads=8, mlp_ratios=(2.0, 2.0))
TOWERS = {  # test name: (skinjax module, port module, skinjax importer, route variable)
    "caformer-small-test": (
        lambda dtype=None: jax_caformer.CAFormer(**CA_KW, dtype=dtype),
        lambda device=None: caformer.CAFormer(*CA_KW.values(), device=device),
        lambda sd, prefix: import_caformer(sd, CA_KW["depths"], CA_KW["mixers"],
                                           CA_KW["res_scale_stages"], prefix),
        "SKINJAX_CAFORMER_MLP"),
    "coat-small-test": (
        lambda dtype=None: jax_coat.CoaTLite(**COAT_KW, dtype=dtype),
        lambda device=None: coat.CoaTLite(*COAT_KW.values(), device=device),
        lambda sd, prefix: import_coat(sd, COAT_KW["depths"], prefix=prefix),
        "SKINJAX_COAT_MLP"),
}


def _cfg(tower):
    return dict(num_classes=5, num_heads=4, cnn_model_name=tower, common_dim=32,
                text_encoder_dim_output=32, vocab_size=9, attention_mechanism=RGATT)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_towers(monkeypatch):
    """The small towers as backbones in both registries and in the JAX
    importer's dispatch; undone after the test."""
    importer = torch_import.import_backbone
    for name, (jctor, pctor, _, _) in TOWERS.items():
        monkeypatch.setitem(jax_backbones._REGISTRY, name, (
            lambda name=None, dtype=None, common_dim=512, _c=jctor: _c(dtype), 32))
        monkeypatch.setitem(port_backbones._REGISTRY, name, (pctor, 32))

    def import_backbone(sd, backbone, prefix=""):
        if backbone in TOWERS:
            return TOWERS[backbone][2](sd, prefix), {}
        return importer(sd, backbone, prefix)

    monkeypatch.setattr(torch_import, "import_backbone", import_backbone)


@pytest.mark.parametrize("route", ["default", "all"])
@pytest.mark.parametrize("tower", list(TOWERS))
def test_converts_both_ways_and_matches(small_towers, monkeypatch, tower, route):
    """skinjax's random tree → state_dict_from_flax → the port (strict load):
    the importer reads the state_dict back to the same tree, leaf for leaf;
    the port's RG-ATT logits match skinjax's in fp32 at 1e-4, on skinjax's
    default route and with every MLP through its Pallas kernel; the port's
    tower ran the twins (the kernels launched nothing)."""
    cfg = _cfg(tower)
    if route == "all":
        monkeypatch.setenv(TOWERS[tower][3], "all")
    model = JaxModel(**cfg)
    variables = jax_variables(model, (HW, HW), cfg["vocab_size"], seed=2)
    params = variables["params"]
    sd = state_dict_from_flax(params, {})
    port = load_numpy_state_dict(MultimodalModel(**cfg), sd).eval()

    back = TOWERS[tower][2]({k: np.asarray(v) for k, v in sd.items()}, "image_encoder.")
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        params["image_encoder"])
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params["image_encoder"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(2, cfg["vocab_size"])).astype(np.float32)
    fm.reset_launches()
    tga.reset_launches()
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    assert sum(fm.LAUNCHES.values()) == sum(tga.LAUNCHES.values()) == 0
    ref = np.asarray(jax.jit(model.apply)(variables, img, meta))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tower", list(TOWERS))
def test_train_steps_match_skinjax(small_towers, jax_without_dropout, tower):
    """Two weighted-CE Adam steps, fp32, augmentation off, from the same
    weights and batches, against skinjax's own train step (the checks of
    tests/test_torch_train.py), with the concatenation head (RG-ATT's is held
    by the test above and by the other towers' tests; the lighter head
    halves skinjax's compile). Every 1-D parameter (StarReLU's scalars and
    the residual scales included) is moved off its initial value first, so
    every term matters."""
    cfg = dict(_cfg(tower), attention_mechanism="concatenation")
    steps, B, lr, wd = 2, 4, 3e-4, 1e-4
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (steps, B, HW, HW, 3), dtype=np.uint8)
    metas = rng.normal(size=(steps, B, cfg["vocab_size"])).astype(np.float32)
    labels = rng.integers(0, cfg["num_classes"], (steps, B)).astype(np.int32)
    cw = rng.uniform(0.5, 2.0, cfg["num_classes"]).astype(np.float32)

    port = _perturbed(init_weights(MultimodalModel(**cfg, dropout_rate=0.0), seed=8), seed=9)
    jmodel = JaxModel(**cfg, dropout_rate=0.0)
    params = _to_jax(port, cfg, HW)
    tx = jax_make_optimizer(lr, wd)
    jstep = jsteps.make_train_step_weighted(jmodel, tx, "weighted_ce", augment=False,
                                            image_dtype=jnp.float32)
    jstate = jsteps.TrainState(params=params, batch_stats={}, opt_state=tx.init(params),
                               step=jnp.asarray(0, jnp.int32))
    jax_losses = []
    for s in range(steps):
        jstate, loss = jstep(jstate, jnp.asarray(imgs[s]), jnp.asarray(metas[s]),
                             jnp.asarray(labels[s]), jax.random.key(0), jnp.asarray(cw))
        jax_losses.append(float(loss))
        if s == 0:
            jax_params1 = _leaves(jstate.params)
    jax_params = _leaves(jstate.params)

    state = build_state(port, TrainConfig(device="cpu", learning_rate=lr, weight_decay=wd))
    step = make_train_step_weighted(augment=False, image_dtype=torch.float32)
    port_losses = []
    for s in range(steps):
        port_losses.append(float(step(state, torch.from_numpy(imgs[s]),
                                      torch.from_numpy(metas[s]), torch.from_numpy(labels[s]), 0,
                                      torch.from_numpy(cw))))
        if s == 0:
            port_params1 = _leaves(_to_jax(port, cfg, HW))
    port_params = _leaves(_to_jax(port, cfg, HW))

    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=2e-5)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-3)
    assert set(port_params) == set(jax_params)
    _assert_adam_close(port_params1, jax_params1, steps=1, far_share=1e-4, near=0.01 * lr)
    _assert_adam_close(port_params, jax_params, steps=steps, far_share=1e-3, near=lr)


@functools.lru_cache(maxsize=None)
def _jax_published(name):
    """skinjax's published tower at full width, traced once by
    ``jax.eval_shape`` of ``init`` (nothing drawn): its parameter shapes, and
    its trainable mask in each mode read inside the trace, where the
    parameter dicts still keep creation order (the freeze policy's "last
    layer" reads it), as {mode: {state_dict key: flag}} (each leaf stood in
    for by an array of its rank)."""
    module = jax_backbones._REGISTRY[name][0](name)
    masks = {}

    def init(key, x):
        params = module.init(key, x)["params"]
        for mode in FREEZE_MODES:
            flags = jax_trainable_mask({"image_encoder": params}, mode)["image_encoder"]
            arrays = jax.tree_util.tree_map(lambda f, p: np.full((1,) * p.ndim, f), flags,
                                            params)
            masks[mode] = {k: bool(v.all()) for k, v in
                           state_dict_from_flax({"image_encoder": arrays}, {}).items()}
        return params

    return jax.eval_shape(init, jax.random.key(0), jnp.zeros((1, HW, HW, 3))), masks


@pytest.mark.parametrize("mode", FREEZE_MODES)
@pytest.mark.parametrize("name", ["caformer_b36", "coat_lite_small"])
def test_freeze_policy_selects_skinjax_parameters(name, mode):
    """skinjax's trainable set, mapped through state_dict_from_flax's key
    map, is the port's in each mode on the published tower. "partial" on
    CAFormer-b36: skinjax's "block11" marker matches stage1_block11 and
    stage2_block11, the port's "blocks.11." the same two blocks, and "head"
    the head norm; on CoaT-lite no marker matches. "last layer": the head
    norm and norm4. The port's tower is shapes only."""
    want = _jax_published(name)[1][mode]
    holder = nn.Module()
    holder.image_encoder = create_backbone(name, device="meta")[0]
    got = trainable_mask(holder, mode)
    assert got == want
    on = {k for k, v in got.items() if v}
    if mode == "partial" and name == "caformer_b36":
        blocks = {k.split(".")[2] + "." + k.split(".")[4] for k in on if ".blocks." in k}
        assert blocks == {"1.11", "2.11"}
        assert on - {k for k in on if ".blocks." in k} == {"image_encoder.head.norm.weight",
                                                           "image_encoder.head.norm.bias"}
    if mode == "partial" and name == "coat_lite_small":
        assert not on
    if mode == "last_layer_unfrozen_weights":
        last = "head.norm" if name == "caformer_b36" else "norm4"
        assert on == {f"image_encoder.{last}.weight", f"image_encoder.{last}.bias"}


@pytest.mark.parametrize("name,count", [("caformer_b36", 93_312_102),
                                        ("coat_lite_small", 19_325_504)])
def test_published_model(name, count):
    """``create_backbone(name)`` at full width on the meta device: skinjax's
    feature width and parameter count, and, under timm's names, the keys
    that skinjax's tree converts to."""
    tower, feat = create_backbone(name, device="meta")
    assert feat == jax_backbones._REGISTRY[name][1]
    shapes, masks = _jax_published(name)
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in tower.parameters()) == jax_count == count
    assert set(masks["unfrozen_weights"]) == {f"image_encoder.{k}" for k in tower.state_dict()}


# one small tower a family: (skinjax module, the port's), 32×32 images
FAMILIES = {
    "resnet": (lambda: jax_resnet.ResNet(stage_sizes=(1, 1), width=8),
               lambda: resnet.ResNet((1, 1), "basic", width=8, device="meta")),
    "davit": (lambda: jax_davit.DaViT(dims=(16, 32), depths=(1, 1), heads=(1, 2), window=4),
              lambda: davit.DaViT((16, 32), (1, 1), (1, 2), window=4, device="meta")),
    "vit": (lambda: jax_vit.ViT(dim=16, depth=1, num_heads=1),
            lambda: vit.VisionTransformer(16, 1, 1, img_size=HW, device="meta")),
    "beit": (lambda: jax_beit.Beit(dim=16, depth=1, num_heads=1),
             lambda: beit.Beit(16, 1, 1, img_size=HW, device="meta")),
    "mvit": (lambda: jax_mvit.MViTv2(dims=(8, 16), depths=(1, 1), heads=(1, 2)),
             lambda: mvit.MViTv2((8, 16), (1, 1), (1, 2), img_size=HW, device="meta")),
    "caformer": (lambda: jax_caformer.CAFormer(**CA_KW),
                 lambda: caformer.CAFormer(*CA_KW.values(), device="meta")),
    "caformer-one-stage": (lambda: jax_caformer.CAFormer(dims=(16,), depths=(1,)),
                           lambda: caformer.CAFormer((16,), (1,), device="meta")),
    "coat": (lambda: jax_coat.CoaTLite(**COAT_KW),
             lambda: coat.CoaTLite(*COAT_KW.values(), device="meta")),
    "swin": (lambda: jax_zoo.Swin(dims=(16, 32), depths=(2, 2), heads=(1, 2), window=4),
             lambda: swin.Swin((16, 32), (2, 2), (1, 2), window=4, device="meta")),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dict_from_flax_dispatches_on_tree_markers(family):
    """Each family's tree converts by its own markers to exactly the port
    tower's state_dict keys and shapes: a CAFormer tree (which has a
    ``stem_conv``, as DaViT's does) as CAFormer, with or without a
    downsample, a Swin tree (``patch_norm``) as Swin, and the other families
    as before."""
    jmodule, pmodule = FAMILIES[family]
    variables = jax.eval_shape(jmodule().init, jax.random.key(0), jnp.zeros((1, HW, HW, 3)))
    arrays = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(variables))
    sd = state_dict_from_flax({"image_encoder": arrays["params"]},
                              {"image_encoder": arrays.get("batch_stats", {})})
    want = {f"image_encoder.{k}": tuple(v.shape) for k, v in pmodule().state_dict().items()}
    assert {k: v.shape for k, v in sd.items()} == want
