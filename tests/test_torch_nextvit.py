"""The port's NextViT against skinjax's: a narrow tower (stem (16, 16, 32);
stages [32] NCB, [64 NCB, 128 NTB], [128 NTB], [128 NTB]: E-MHSA on 96
channels with its tokens pooled by 16, 4 and 1, and the MHCA half on 32;
80×80 images, so the pooled groups leave a ragged tail at stages 1 and 2),
weights drawn on skinjax's tree (BatchNorm statistics included) and carried
across by ``state_dict_from_flax``. The converter's round trip through
``import_nextvit``; the train-mode forward, every parameter gradient and the
running statistics against skinjax in fp32, on both BatchNorm routes (native,
and K6's through ``fuse_batch_norms``); the RG-ATT model around the tower;
and, on the published ``nextvit_small`` (shapes only), the parameter count,
the keys and the freeze policy in every mode."""

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
from skinjax.models.backbones import nextvit as jnext
from skinjax.models.torch_import import import_nextvit
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.backbones import create_backbone, nextvit
from skinjax_torch.models.weights import load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import batch_norm as tbn
from skinjax_torch.train.optimizer import FREEZE_MODES, trainable_mask
from tests.test_torch_cnn_zoo import (
    ROUTES,
    assert_tower_matches,
    draw_variables,
    jax_train,
    port_train,
    published,
    to_port,
)
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

CHANNELS = ((32,), (64, 128), (128,), (128,))
TYPES = (("ncb",), ("ncb", "ntb"), ("ntb",), ("ntb",))
DEPTHS = tuple(len(c) for c in CHANNELS)
KW = dict(stem_chs=(16, 16, 32), stage_channels=CHANNELS, stage_types=TYPES)
HW = 80


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _narrow():
    """skinjax's narrow NextViT: drawn variables, an input, a cotangent, its
    train-mode features, gradients and statistics."""
    module = jnext.NextViT(**KW)
    params, stats = draw_variables(module, HW, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    dy = rng.normal(size=(2, CHANNELS[-1][-1])).astype(np.float32)
    return (params, stats, x, dy) + jax_train(module, params, stats, x, dy)


def _port():
    return nextvit.NextViT(DEPTHS, **KW)


def test_converts_both_ways():
    """skinjax's tree → state_dict_from_flax (the stage depths given) →
    timm's keys (the port's, every one, buffers included) →
    import_nextvit → the same parameters and statistics, leaf for leaf."""
    params, stats = _narrow()[:2]
    sd = state_dict_from_flax({"image_encoder": params}, {"image_encoder": stats},
                              nextvit_depths=DEPTHS)
    assert set(sd) == {f"image_encoder.{k}" for k in _port().state_dict()}
    back_p, back_s = import_nextvit({k: np.asarray(v) for k, v in sd.items()}, DEPTHS,
                                    CHANNELS, TYPES, prefix="image_encoder.")
    for got, want in ((back_p, params), (back_s, stats)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="stage depths"):
        state_dict_from_flax({"image_encoder": params}, {"image_encoder": stats})


@pytest.mark.parametrize("route", ROUTES)
def test_forward_and_gradients_match_skinjax(route):
    """The port's tower in train mode on each BatchNorm route against
    skinjax's, fp32: the 128 pooled features within 1e-4, every parameter
    gradient of sum(features·dy) within 1e-4 of max(1, |g|), the running
    statistics of all 27 BatchNorms (two of them ``BatchNorm1d`` on the
    pooled tokens) within 1e-4."""
    params, stats, x, dy, y_ref, grads, new_stats = _narrow()
    port = _port()
    port.load_state_dict(to_port(params, stats, nextvit_depths=DEPTHS))
    y = port_train(port, route, x, dy)
    n_bn = sum(isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)) for m in port.modules())
    assert n_bn == 27
    assert tbn.count_batch_norms(port) == (n_bn if route == "k6" else 0)
    assert_tower_matches(port, y, y_ref, grads, new_stats, nextvit_depths=DEPTHS)


def test_rgatt_model_matches_skinjax(monkeypatch):
    """The RG-ATT multimodal model around the narrow tower, registered under
    a test name in both registries: skinjax's random tree → the port (strict
    load) → fp32 logits within 1e-4, in eval mode."""
    name = "nextvit-narrow-test"
    monkeypatch.setitem(jax_backbones._REGISTRY, name, (
        lambda name=None, dtype=None, common_dim=512: jnext.NextViT(**KW, dtype=dtype), 128))
    monkeypatch.setitem(port_backbones._REGISTRY, name, (
        lambda device=None: nextvit.NextViT(DEPTHS, **KW, device=device), 128))
    cfg = dict(num_classes=5, num_heads=4, cnn_model_name=name, common_dim=32,
               text_encoder_dim_output=32, vocab_size=9,
               attention_mechanism="att-intramodal+residual+cross-attention-metadados")
    model = JaxModel(**cfg)
    variables = jax_variables(model, (HW, HW), cfg["vocab_size"], seed=2)
    port = load_numpy_state_dict(
        MultimodalModel(**cfg), state_dict_from_flax(variables["params"],
                                                     variables["batch_stats"],
                                                     nextvit_depths=DEPTHS)).eval()
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(2, cfg["vocab_size"])).astype(np.float32)
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    ref = np.asarray(jax.jit(model.apply)(variables, img, meta))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_plan_copies():
    """The port's copies of make_divisible and nextvit_plan are skinjax's."""
    for v in (48, 72, 96, 192, 288, 384, 768, 1024 * 0.75):
        assert nextvit.make_divisible(v) == jnext.make_divisible(v)
    for depths in ((3, 4, 10, 3), (3, 4, 20, 3)):
        assert nextvit.nextvit_plan(depths) == jnext.nextvit_plan(depths)


def test_published_model():
    """``create_backbone("nextvit_small")`` on the meta device: skinjax's
    feature width (1024) and parameter count, and, under timm's names, the
    parameters that skinjax's tree converts to; 61 BatchNorms, three of them
    ``BatchNorm1d``."""
    tower, feat = create_backbone("nextvit_small", device="meta")
    assert feat == jax_backbones._REGISTRY["nextvit_small"][1] == 1024
    shapes, masks = published("nextvit_small", 64)
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in tower.parameters()) == jax_count == 30_738_368
    assert set(masks["unfrozen_weights"]) == {f"image_encoder.{k}"
                                              for k, _ in tower.named_parameters()}
    assert sum(isinstance(m, nn.BatchNorm2d) for m in tower.modules()) == 58
    assert sum(isinstance(m, nn.BatchNorm1d) for m in tower.modules()) == 3


@pytest.mark.parametrize("mode", FREEZE_MODES)
def test_freeze_policy_selects_skinjax_parameters(mode):
    """skinjax's trainable set, through state_dict_from_flax's key map, is
    the port's in each mode on nextvit_small: no "partial" marker of
    skinjax's names a NextViT scope (nothing trains), and the last layer is
    the final BatchNorm."""
    want = published("nextvit_small", 64)[1][mode]
    holder = nn.Module()
    holder.image_encoder = create_backbone("nextvit_small", device="meta")[0]
    got = trainable_mask(holder, mode)
    assert got == want
    on = {k for k, v in got.items() if v}
    if mode == "partial":
        assert not on
    if mode == "last_layer_unfrozen_weights":
        assert on == {"image_encoder.norm.weight", "image_encoder.norm.bias"}
