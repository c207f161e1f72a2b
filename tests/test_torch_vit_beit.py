"""The port's ViT and BEiT towers against skinjax: a small ViT and a small
BEiT (width 128, depth 2, 2 heads, so 64 channels a head as in the published
models; 64×64 images, 17 tokens) through ``state_dict_from_flax`` and back
through ``import_vit``/``import_beit``; the multimodal model (RG-ATT) around
each, forward in fp32 against skinjax's XLA path and its Pallas path; three
Adam steps against skinjax's own step, unfrozen and frozen; the relative
position index; the registry; the freeze policy's trainable sets at the
published depths; ``init_weights``. The small towers are registered under
test names in both backbone registries for the length of each test only."""

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
from skinjax.models.backbones.beit import Beit as JaxBeit
from skinjax.models.backbones.beit import beit_relative_position_index as jax_rel_index
from skinjax.models.backbones.vit import ViT as JaxViT
from skinjax.models.torch_import import import_beit, import_vit
from skinjax.train import steps as jsteps
from skinjax.train.optimizer import make_optimizer as jax_make_optimizer
from skinjax.train.optimizer import trainable_mask as jax_trainable_mask
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.backbones import beit, create_backbone, vit
from skinjax_torch.models.weights import init_weights, load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import global_attention as tga
from skinjax_torch.train.loop import TrainConfig, build_state
from skinjax_torch.train.optimizer import trainable_mask
from skinjax_torch.train.steps import make_train_step_weighted
from tests.test_torch_davit import _perturbed, _to_jax
from tests.test_torch_train import _assert_adam_close, _leaves, jax_without_dropout  # noqa: F401
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

DIM, DEPTH, HEADS, HW = 128, 2, 2, 64
RGATT = "att-intramodal+residual+cross-attention-metadados"
TOWERS = {  # test name: (skinjax module, port module, skinjax importer)
    "vit-small-test": (
        lambda dtype=None: JaxViT(dim=DIM, depth=DEPTH, num_heads=HEADS, dtype=dtype),
        lambda device=None: vit.VisionTransformer(DIM, DEPTH, HEADS, img_size=HW, device=device),
        lambda sd, prefix: import_vit(sd, DEPTH, DIM, prefix)),
    "beit-small-test": (
        lambda dtype=None: JaxBeit(dim=DIM, depth=DEPTH, num_heads=HEADS, dtype=dtype),
        lambda device=None: beit.Beit(DIM, DEPTH, HEADS, img_size=HW, device=device),
        lambda sd, prefix: import_beit(sd, DEPTH, prefix)),
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
    for name, (jax_ctor, port_ctor, _) in TOWERS.items():
        monkeypatch.setitem(jax_backbones._REGISTRY, name, (
            lambda name=None, dtype=None, common_dim=512, _c=jax_ctor: _c(dtype), DIM))
        monkeypatch.setitem(port_backbones._REGISTRY, name, (port_ctor, DIM))
    importer = torch_import.import_backbone

    def import_backbone(sd, backbone, prefix=""):
        if backbone in TOWERS:
            return TOWERS[backbone][2](sd, prefix), {}
        return importer(sd, backbone, prefix)

    monkeypatch.setattr(torch_import, "import_backbone", import_backbone)


@pytest.mark.parametrize("tower", list(TOWERS))
def test_converts_both_ways_and_matches(small_towers, monkeypatch, tower):
    """skinjax's random tree → state_dict_from_flax → the port (strict
    load): the importer reads the state_dict back to the same tree, leaf for
    leaf; the port's RG-ATT logits match skinjax's in fp32 at 1e-4, through
    skinjax's XLA attention and through its Pallas kernel (interpret mode);
    the port's own attention ran the twins, K12 launched nothing."""
    cfg = _cfg(tower)
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
    tga.reset_launches()
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    assert sum(tga.LAUNCHES.values()) == 0
    ref = np.asarray(jax.jit(model.apply)(variables, img, meta))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    monkeypatch.setenv("SKINJAX_GLOBATTN", "pallas")
    ref = np.asarray(jax.jit(model.apply)(variables, img, meta))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["unfrozen_weights", "frozen_weights"])
@pytest.mark.parametrize("tower", list(TOWERS))
def test_train_steps_match_skinjax(small_towers, jax_without_dropout, tower, mode):
    """Three weighted-CE Adam steps, fp32, augmentation off, from the same
    weights and batches, against skinjax's own train step and masked
    optimizer (the checks of tests/test_torch_train.py)."""
    cfg = _cfg(tower)
    steps, B, lr, wd = 3, 4, 3e-4, 1e-4
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (steps, B, HW, HW, 3), dtype=np.uint8)
    metas = rng.normal(size=(steps, B, cfg["vocab_size"])).astype(np.float32)
    labels = rng.integers(0, cfg["num_classes"], (steps, B)).astype(np.int32)
    cw = rng.uniform(0.5, 2.0, cfg["num_classes"]).astype(np.float32)

    port = _perturbed(init_weights(MultimodalModel(**cfg, dropout_rate=0.0), seed=8), seed=9)
    with torch.no_grad():  # a bias table and layer scales that are not 0 and 1e-5
        for name, p in port.image_encoder.named_parameters():
            if name.endswith(("relative_position_bias_table", "gamma_1", "gamma_2")):
                p.copy_(0.3 * torch.randn(p.shape, generator=torch.Generator().manual_seed(10)))
    jmodel = JaxModel(**cfg, dropout_rate=0.0)
    params = _to_jax(port, cfg, HW)
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
            port_params1 = _leaves(_to_jax(port, cfg, HW))
    port_params = _leaves(_to_jax(port, cfg, HW))

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


@pytest.mark.parametrize("grid", [4, 14])
def test_relative_position_index_matches_skinjax(grid):
    np.testing.assert_array_equal(beit.beit_relative_position_index(grid, grid),
                                  jax_rel_index(grid, grid))
    attn = beit.BeitAttention(64, 2, grid)
    assert "relative_position_index" not in attn.state_dict()
    assert attn.relative_bias().shape == (2, grid * grid + 1, grid * grid + 1)


def test_registry_has_the_five_names():
    """skinjax's five ViT/BEiT names with its feature widths; built on the
    meta device (shapes only) at the published widths and depths."""
    want = {"vit_tiny_patch16_224": (192, 12, vit.VisionTransformer),
            "vit_small_patch16_224": (384, 12, vit.VisionTransformer),
            "vit_base_patch16_224": (768, 12, vit.VisionTransformer),
            "vit_large_patch16_224": (1024, 24, vit.VisionTransformer),
            "beitv2_large_patch16_224": (1024, 24, beit.Beit)}
    for name, (dim, depth, cls) in want.items():
        module, feat = create_backbone(name, device="meta")
        assert feat == dim == jax_backbones._REGISTRY[name][1], name
        assert isinstance(module, cls) and len(module.blocks) == depth, name
        assert module.blocks[0].attn.qkv.in_features == dim, name
    tower, _ = create_backbone("beitv2_large_patch16_224", device="meta")
    assert 300e6 < sum(p.numel() for p in tower.parameters()) < 310e6  # BEiT-v2-large: ~304 M


@functools.lru_cache(maxsize=None)
def _jax_flags(arch, depth):
    """skinjax's trainable mask in each mode over a narrow tower at a
    published depth, as arrays of its flags shaped like the parameters:
    {mode: tree}. The masks are taken inside
    ``jax.eval_shape`` of ``init``, where the parameter dicts still keep
    creation order, which the freeze policy's "last layer" reads (the traced
    output's dicts come back sorted); an eager ``init`` gives the same tree
    and takes seconds."""
    cls = JaxViT if arch == "vit" else JaxBeit
    model = cls(dim=8, depth=depth, num_heads=1)
    out = {}

    def init(key, x):
        tree = model.init(key, x)["params"]
        for mode in ("partial", "last_layer_unfrozen_weights"):
            flags = jax_trainable_mask({"image_encoder": tree}, mode)["image_encoder"]
            out[mode] = jax.tree_util.tree_map(lambda f, p: np.full(np.shape(p), f), flags, tree)
        return tree

    jax.eval_shape(init, jax.random.key(0), jnp.zeros((1, 16, 16, 3)))
    return out


@pytest.mark.parametrize("mode", ["partial", "last_layer_unfrozen_weights"])
@pytest.mark.parametrize("arch,depth", [("vit", 12), ("vit", 24), ("beit", 24)])
def test_freeze_policy_selects_skinjax_parameters(arch, depth, mode):
    """skinjax's trainable set, mapped through state_dict_from_flax's key
    map, is the port's: "partial" trains the same blocks (skinjax's
    "block11"/"block23" markers are the port's "blocks.11."/"blocks.23."),
    "last layer" the same final norm. The port's tower is shapes only."""
    as_arrays = _jax_flags(arch, depth)[mode]
    mapped = state_dict_from_flax({"image_encoder": as_arrays}, {})
    assert all(v.all() or not v.any() for v in mapped.values())
    want = {k for k, v in mapped.items() if v.all()}

    holder = nn.Module()
    cls = vit.VisionTransformer if arch == "vit" else beit.Beit
    holder.image_encoder = cls(8, depth, 1, img_size=16, device="meta")
    got = {k for k, on in trainable_mask(holder, mode).items() if on}
    assert set(mapped) == {k for k, _ in holder.named_parameters()}
    assert got == want and got


def test_init_weights_statistics():
    """skinjax's initialisers for the new parameters."""
    d = 256
    tv = init_weights(vit.VisionTransformer(d, 2, 4, img_size=64), seed=1)
    tb = init_weights(beit.Beit(d, 2, 4, img_size=64), seed=1)
    for t in (tv, tb):
        assert abs(float(t.cls_token.detach().std()) - 0.02) < 0.004
        w = t.patch_embed.proj.weight.detach()
        assert abs(float(w.std()) * (3 * 16 * 16) ** 0.5 - 1) < 0.05  # LeCun normal
    assert abs(float(tv.pos_embed.detach().std()) - 0.02) < 0.002
    for blk in tv.blocks:
        bound = (6.0 / (2 * d)) ** 0.5  # Xavier uniform over each (d, d) block
        for w in (*blk.attn.qkv.weight.detach().split(d), blk.attn.proj.weight.detach()):
            assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.95 * bound
            assert abs(float(w.std()) - bound / 3 ** 0.5) < 0.03 * bound
        assert not blk.attn.qkv.bias.any()
    for blk in tb.blocks:
        w = blk.attn.qkv.weight.detach()
        bound = (6.0 / (4 * d)) ** 0.5  # Xavier uniform over (C, 3C)
        assert float(w.abs().max()) <= bound and abs(float(w.std()) - bound / 3 ** 0.5) < 0.03 * bound
        assert bool((blk.gamma_1 == 1e-5).all()) and bool((blk.gamma_2 == 1e-5).all())
        for t in (blk.attn.q_bias, blk.attn.v_bias, blk.attn.relative_position_bias_table):
            assert not t.any()
        assert abs(float(blk.mlp.fc1.weight.detach().std()) * d ** 0.5 - 1) < 0.05  # LeCun normal
    names = [n for n, _ in tb.named_parameters()]
    assert names[-2:] == ["fc_norm.weight", "fc_norm.bias"]
    with pytest.raises(ValueError, match="covers"):
        tv(torch.zeros(1, 32, 32, 3))
