"""The port's DaViT path against skinjax: the small DaViT of
tests/test_timm_backbones.py (dims (16, 32), depths (1, 2), heads (2, 4),
56×56) through ``state_dict_from_flax`` and back through ``import_davit``;
the full-width davit_tiny + RG-ATT forward; three Adam steps of a
small-DaViT multimodal model against skinjax's own step, unfrozen and
frozen; the fused engine against skinjax's fused engine. The small DaViT is
registered under a test name in both backbone registries for the length of
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
from skinjax.models.backbones.davit import DaViT as JaxDaViT
from skinjax.models.torch_import import filter_to_template, import_davit
from skinjax.serve.engine import InferenceEngine as JaxEngine
from skinjax.train import steps as jsteps
from skinjax.train.optimizer import make_optimizer as jax_make_optimizer
from skinjax.train.optimizer import trainable_mask as jax_trainable_mask
from skinjax_torch import DAVIT
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.backbones import create_backbone
from skinjax_torch.models.backbones.davit import DaViT
from skinjax_torch.models.weights import init_weights, load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import window_attention as twa
from skinjax_torch.serve.engine import InferenceEngine
from skinjax_torch.train.loop import TrainConfig, build_state
from skinjax_torch.train.optimizer import FREEZE_MODES, trainable_mask
from skinjax_torch.train.steps import make_train_step_weighted
from tests.test_torch_train import _assert_adam_close, _leaves, jax_without_dropout  # noqa: F401
from tests.test_torch_weights import jax_variable_shapes, jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

SMALL = "davit-small-test"
DIMS, DEPTHS, HEADS = (16, 32), (1, 2), (2, 4)
RGATT = "att-intramodal+residual+cross-attention-metadados"
CFG = dict(num_classes=5, num_heads=4, cnn_model_name=SMALL, common_dim=32,
           text_encoder_dim_output=32, vocab_size=9, attention_mechanism=RGATT)
HW = 56


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_davit(monkeypatch):
    """The small DaViT as backbone ``SMALL`` in both registries, and in the
    JAX importer's dispatch; undone after the test."""
    monkeypatch.setitem(jax_backbones._REGISTRY, SMALL, (
        lambda name=None, dtype=None, common_dim=512: JaxDaViT(DIMS, DEPTHS, HEADS, dtype=dtype),
        DIMS[-1]))
    monkeypatch.setitem(port_backbones._REGISTRY, SMALL, (
        lambda device=None: DaViT(DIMS, DEPTHS, HEADS, device=device), DIMS[-1]))
    importer = torch_import.import_backbone

    def import_backbone(sd, backbone, prefix=""):
        if backbone == SMALL:
            return import_davit(sd, DEPTHS, prefix), {}
        return importer(sd, backbone, prefix)

    monkeypatch.setattr(torch_import, "import_backbone", import_backbone)


def _to_jax(port, cfg, hw):
    """The port's weights as the JAX model's params (the JAX importer; the
    parameter template traced once per configuration)."""
    sd = {k: v.detach().numpy().copy() for k, v in port.state_dict().items()}
    params, _ = torch_import.import_multimodal_checkpoint(sd, common_dim=cfg["common_dim"],
                                                          backbone=cfg["cnn_model_name"])
    template = jax_variable_shapes(JaxModel(**cfg), (hw, hw), cfg["vocab_size"])
    return filter_to_template(params, template["params"])


def _perturbed(model, seed):
    """Random biases and norm affines, so every term matters; dropout 0."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def test_small_davit_converts_both_ways_and_matches(small_davit):
    """skinjax's random tree → state_dict_from_flax → the port (strict load):
    the same logits; and import_davit reads the state_dict back to the same
    tree, leaf for leaf."""
    model = JaxModel(**CFG)
    variables = jax_variables(model, (HW, HW), CFG["vocab_size"], seed=2)
    params = variables["params"]
    sd = state_dict_from_flax(params, variables.get("batch_stats", {}))
    port = load_numpy_state_dict(MultimodalModel(**CFG), sd).eval()

    back = import_davit({k: np.asarray(v) for k, v in sd.items()}, DEPTHS, "image_encoder.")
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        params["image_encoder"])
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params["image_encoder"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(2, CFG["vocab_size"])).astype(np.float32)
    ref = np.asarray(jax.jit(model.apply)(variables, img, meta))
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_davit_tiny_rgatt_matches_skinjax():
    """The full-width configuration (davit_tiny + one-hot MLP + RG-ATT,
    common_dim 512), B=1, 224², fp32: the port's seeded weights through the
    JAX importer into skinjax's model."""
    cfg = dict(DAVIT, common_dim=512)
    port = _perturbed(init_weights(MultimodalModel(**cfg), seed=4), seed=5).eval()
    params = _to_jax(port, cfg, 224)
    rng = np.random.default_rng(6)
    img = rng.normal(size=(1, 224, 224, 3)).astype(np.float32)
    meta = rng.normal(size=(1, cfg["vocab_size"])).astype(np.float32)
    ref = np.asarray(jax.jit(JaxModel(**cfg).apply)({"params": params}, img, meta))
    twa.reset_launches()
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    assert sum(twa.LAUNCHES.values()) == 0
    # fp32 through 12 blocks and 4 stages, summed in other orders
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("mode", ["unfrozen_weights", "frozen_weights"])
def test_train_steps_match_skinjax(small_davit, jax_without_dropout, mode):
    """Three weighted-CE Adam steps, fp32, augmentation off, from the same
    weights and batches, against skinjax's own train step and masked
    optimizer (the checks of tests/test_torch_train.py)."""
    steps, B, lr, wd = 3, 8, 3e-4, 1e-4
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (steps, B, HW, HW, 3), dtype=np.uint8)
    metas = rng.normal(size=(steps, B, CFG["vocab_size"])).astype(np.float32)
    labels = rng.integers(0, CFG["num_classes"], (steps, B)).astype(np.int32)
    cw = rng.uniform(0.5, 2.0, CFG["num_classes"]).astype(np.float32)

    port = _perturbed(init_weights(MultimodalModel(**CFG, dropout_rate=0.0), seed=8), seed=9)
    jmodel = JaxModel(**CFG, dropout_rate=0.0)
    params = _to_jax(port, CFG, HW)
    mask = None if mode == "unfrozen_weights" else jax_trainable_mask(params, mode)
    tx = jax_make_optimizer(lr, wd, mask=mask)
    jstep = jsteps.make_train_step_weighted(jmodel, tx, "weighted_ce", augment=False,
                                            image_dtype=jnp.float32, trainable_mask=mask)
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

    state = build_state(port, TrainConfig(device="cpu", learning_rate=lr, weight_decay=wd,
                                          unfreeze_weights=mode))
    encoder0 = {k: v.detach().clone() for k, v in port.image_encoder.named_parameters()}
    step = make_train_step_weighted(augment=False, image_dtype=torch.float32)
    port_losses = []
    for s in range(steps):
        port_losses.append(float(step(state, torch.from_numpy(imgs[s]),
                                      torch.from_numpy(metas[s]), torch.from_numpy(labels[s]), 0,
                                      torch.from_numpy(cw))))
        if s == 0:
            port_params1 = _leaves(_to_jax(port, CFG, HW))
    port_params = _leaves(_to_jax(port, CFG, HW))

    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=2e-5)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-3)
    assert set(port_params) == set(jax_params)
    _assert_adam_close(port_params1, jax_params1, steps=1, far_share=1e-4, near=0.01 * lr)
    _assert_adam_close(port_params, jax_params, steps=steps, far_share=1e-3, near=lr)
    if mode == "frozen_weights":
        for k, v in port.image_encoder.named_parameters():
            assert torch.equal(v, encoder0[k]), k
        assert all(np.array_equal(jax_params[k], _leaves(params)[k])
                   for k in jax_params if "image_encoder" in k)


@functools.lru_cache(maxsize=None)
def _jax_davit_tiny_masks():
    """skinjax's trainable mask over davit_tiny in each mode, read inside
    ``jax.eval_shape`` of ``init`` at 224×224 (nothing drawn), where the
    parameter dicts still keep creation order (the freeze policy's "last
    layer" reads it), as {mode: {state_dict key: flag}} (each leaf stood in
    for by an array of its rank)."""
    module = jax_backbones._REGISTRY["davit_tiny"][0]("davit_tiny")
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

    jax.eval_shape(init, jax.random.key(0), jnp.zeros((1, 224, 224, 3)))
    return masks


@pytest.mark.parametrize("mode", FREEZE_MODES)
def test_freeze_policy_selects_skinjax_parameters(mode):
    """skinjax's trainable set over davit_tiny, mapped through
    state_dict_from_flax's key map, is the port's in each mode: all 210
    tensors unfrozen, none frozen, the head norm in "partial" (skinjax's
    "head" marker) and in "last layer". The port's tower is shapes only."""
    want = _jax_davit_tiny_masks()[mode]
    holder = nn.Module()
    holder.image_encoder = create_backbone("davit_tiny", device="meta")[0]
    got = trainable_mask(holder, mode)
    assert set(got) == set(want)
    assert got == want
    expect = {"unfrozen_weights": 210, "frozen_weights": 0, "partial": 2,
              "last_layer_unfrozen_weights": 2}[mode]
    assert sum(got.values()) == expect


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_fused_engine_matches_jax_fused_engine(small_davit, kind):
    model = JaxModel(**CFG)
    variables = jax_variables(model, (HW, HW), CFG["vocab_size"], seed=10)
    port = load_numpy_state_dict(MultimodalModel(**CFG), state_dict_from_flax(
        variables["params"], {}))
    rng = np.random.default_rng(11)
    u8 = rng.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)
    img = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(2, CFG["vocab_size"])).astype(np.float32)
    image = u8 if kind == "uint8" else img
    ref = JaxEngine(model, variables, use_fused=True).predict_probs(image, meta)
    out = InferenceEngine(port, use_fused=True, device="cpu").predict_probs(image, meta)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


class _Tokens(nn.Module):
    """A tower that returns a token sequence (B, 3, 8): CLS first."""

    def forward(self, x):
        B = x.shape[0]
        return torch.arange(B * 24, dtype=torch.float32).reshape(B, 3, 8) + x.mean()


def test_features_pool_by_the_towers_rank(monkeypatch):
    """A map is pooled, a token sequence gives its first token, a vector is
    used as it is, as in skinjax's model and engine."""
    monkeypatch.setitem(port_backbones._REGISTRY, "tokens-test", (lambda device=None: _Tokens(),
                                                                  8))
    model = MultimodalModel(num_classes=3, cnn_model_name="tokens-test", common_dim=8,
                            vocab_size=4)
    model.image_projector = nn.Identity()
    x = torch.zeros(2, 4, 4, 3)
    img, _ = model.features(x, torch.zeros(2, 4))
    np.testing.assert_array_equal(img.numpy(), np.arange(48).reshape(2, 3, 8)[:, 0])
    tower = DaViT(DIMS, DEPTHS, HEADS).eval()
    with torch.no_grad():
        assert tower(torch.zeros(2, HW, HW, 3)).shape == (2, DIMS[-1])


def test_init_weights_and_bad_maps():
    """init_weights draws every conv (depthwise ones too) and sets every
    LayerNorm, the head norm included, to unit scale and zero shift; a map
    the window does not tile raises."""
    tower = init_weights(DaViT(DIMS, DEPTHS, HEADS), seed=12)
    names = [n for n, _ in tower.named_parameters()]
    assert names[-2:] == ["head.norm.weight", "head.norm.bias"]
    for name, m in tower.named_modules():
        if isinstance(m, nn.Conv2d):
            assert float(m.weight.detach().std()) > 0 and not m.bias.any(), name
        elif isinstance(m, nn.LayerNorm):
            assert bool((m.weight == 1).all()) and not m.bias.any(), name
    with pytest.raises(ValueError, match="multiples of the window"):
        tower(torch.zeros(1, 60, 60, 3))
