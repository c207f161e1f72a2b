"""The port's MViTv2 tower against skinjax: the relative-position distance
maps; a small MViTv2 (dims (16, 32, 64, 128), heads (1, 2, 4, 8), depths
(1, 2, 2, 2), 64×64 images: 16 channels a head, and every block kind of the
published model, Nq > Nk, Nq = Nk after a transition, Nq < Nk) through
``state_dict_from_flax`` and back through ``import_mvit``; the multimodal
model (RG-ATT) around it, forward in fp32 against skinjax's XLA path; three
Adam steps against skinjax's own step, unfrozen and frozen; one attention
block against skinjax's with its Pallas kernel (interpret mode), forward and
gradients; the published model's widths, parameter count and block shapes;
the freeze policy's trainable sets at the published depth. The small tower
is registered under a test name in both backbone registries for the length
of each test only."""

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
from skinjax.models.backbones import mvit as jax_mvit
from skinjax.models.torch_import import import_mvit
from skinjax.train import steps as jsteps
from skinjax.train.optimizer import make_optimizer as jax_make_optimizer
from skinjax.train.optimizer import trainable_mask as jax_trainable_mask
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models import weights as port_weights
from skinjax_torch.models.backbones import create_backbone, mvit
from skinjax_torch.models.weights import init_weights, load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import pooled_attention as tpa
from skinjax_torch.train.loop import TrainConfig, build_state
from skinjax_torch.train.optimizer import FREEZE_MODES, trainable_mask
from skinjax_torch.train.steps import make_train_step_weighted
from tests.test_torch_davit import _perturbed, _to_jax
from tests.test_torch_train import _assert_adam_close, _leaves, jax_without_dropout  # noqa: F401
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

DIMS, DEPTHS, HEADS, HW = (16, 32, 64, 128), (1, 2, 2, 2), (1, 2, 4, 8), 64
TOWER = "mvit-small-test"
RGATT = "att-intramodal+residual+cross-attention-metadados"
CFG = dict(num_classes=5, num_heads=4, cnn_model_name=TOWER, common_dim=32,
           text_encoder_dim_output=32, vocab_size=9, attention_mechanism=RGATT)
# mvitv2_small's 16 blocks at 224×224: (heads, Nq, Nk)
PUBLISHED_BLOCKS = ([(1, 3136, 196), (2, 784, 784), (2, 784, 196), (4, 196, 784)]
                    + [(4, 196, 196)] * 10 + [(8, 49, 196), (8, 49, 49)])


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_tower(monkeypatch):
    """The small tower as a backbone in both registries and in the JAX
    importer's dispatch; undone after the test."""
    monkeypatch.setitem(jax_backbones._REGISTRY, TOWER, (
        lambda name=None, dtype=None, common_dim=512: jax_mvit.MViTv2(
            dims=DIMS, depths=DEPTHS, heads=HEADS, dtype=dtype), DIMS[-1]))
    monkeypatch.setitem(port_backbones._REGISTRY, TOWER, (
        lambda device=None: mvit.MViTv2(DIMS, DEPTHS, HEADS, img_size=HW, device=device),
        DIMS[-1]))
    importer = torch_import.import_backbone

    def import_backbone(sd, backbone, prefix=""):
        if backbone == TOWER:
            return import_mvit(sd, DEPTHS, prefix), {}
        return importer(sd, backbone, prefix)

    monkeypatch.setattr(torch_import, "import_backbone", import_backbone)


def test_rel_pos_dists_match_skinjax():
    """The port's copy of ``_rel_pos_dists`` at every (q, k) side pair of
    the published blocks, and at the small tower's."""
    pairs = {(56, 14), (28, 28), (28, 14), (14, 28), (14, 14), (7, 14), (7, 7),
             (16, 4), (8, 8), (8, 4), (4, 8), (4, 4), (2, 4), (2, 2)}
    for q, k in sorted(pairs):
        got, want = mvit._rel_pos_dists(q, k), jax_mvit._rel_pos_dists(q, k)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=str((q, k)))


def test_converts_both_ways_and_matches(small_tower):
    """skinjax's random tree (rel-pos tables included) →
    state_dict_from_flax → the port (strict load): ``import_mvit`` reads the
    state_dict back to the same tree, leaf for leaf; the port's RG-ATT
    logits match skinjax's XLA path in fp32 at 1e-4; the port's attention
    ran the twins, K11 launched nothing."""
    model = JaxModel(**CFG)
    variables = jax_variables(model, (HW, HW), CFG["vocab_size"], seed=2)
    params = variables["params"]
    sd = state_dict_from_flax(params, {})
    port = load_numpy_state_dict(MultimodalModel(**CFG), sd).eval()

    back = import_mvit({k: np.asarray(v) for k, v in sd.items()}, DEPTHS, "image_encoder.")
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        params["image_encoder"])
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params["image_encoder"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(2, CFG["vocab_size"])).astype(np.float32)
    tpa.reset_launches()
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    assert sum(tpa.LAUNCHES.values()) == 0
    ref = np.asarray(jax.jit(model.apply)(variables, img, meta))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["unfrozen_weights", "frozen_weights"])
def test_train_steps_match_skinjax(small_tower, jax_without_dropout, mode):
    """Three weighted-CE Adam steps, fp32, augmentation off, from the same
    weights (random rel-pos tables: skinjax draws them 0) and batches,
    against skinjax's own train step and masked optimizer (the checks of
    tests/test_torch_train.py)."""
    steps, B, lr, wd = 3, 4, 3e-4, 1e-4
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (steps, B, HW, HW, 3), dtype=np.uint8)
    metas = rng.normal(size=(steps, B, CFG["vocab_size"])).astype(np.float32)
    labels = rng.integers(0, CFG["num_classes"], (steps, B)).astype(np.int32)
    cw = rng.uniform(0.5, 2.0, CFG["num_classes"]).astype(np.float32)

    port = _perturbed(init_weights(MultimodalModel(**CFG, dropout_rate=0.0), seed=8), seed=9)
    with torch.no_grad():
        g = torch.Generator().manual_seed(10)
        for name, p in port.image_encoder.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")):
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
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


def _attention_sd(p):
    """skinjax's ``MViTAttention`` params → the port's module's keys."""
    sd = {}
    for lin in ("qkv", "proj"):
        port_weights._linear(sd, lin, p[lin])
    for t in "qkv":
        port_weights._conv(sd, f"pool_{t}", p[f"pool_{t}"])
        port_weights._ln(sd, f"norm_{t}", p[f"norm_{t}"])
    sd["rel_pos_h"], sd["rel_pos_w"] = np.asarray(p["rel_pos_h"]), np.asarray(p["rel_pos_w"])
    return sd


def test_attention_block_matches_skinjax_pallas(monkeypatch):
    """One attention block that expands the width (16 → 32 channels, 2
    heads) and pools keys and values by 2 on an 8×8 map, against skinjax's
    with ``SKINJAX_GLOBATTN=pallas`` (its K11 kernel in interpret mode): the
    output and the gradients of x and of every parameter, fp32."""
    monkeypatch.setenv("SKINJAX_GLOBATTN", "pallas")
    B, feat, dim_in, dim_out, h = 2, (8, 8), 16, 32, 2
    jblock = jax_mvit.MViTAttention(dim_out, h, 1, 2, feat)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 64, dim_in)).astype(np.float32)
    shapes = jax.eval_shape(jblock.init, jax.random.key(0), jnp.zeros((1, 64, dim_in)))
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.normal(size=s.shape)).astype(np.float32), shapes["params"])
    dy = rng.normal(size=(B, 64, dim_out)).astype(np.float32)

    def jfn(p, xx):
        out, _ = jblock.apply({"params": p}, xx)
        return jnp.sum(out * dy), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))

    port = mvit.MViTAttention(dim_in, dim_out, h, 1, 2, feat)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in _attention_sd(params).items()})
    xt = torch.tensor(x, requires_grad=True)
    out = port(xt)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4, rtol=1e-4)
    want = _attention_sd(gp)
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4, err_msg=k)


def test_published_model():
    """``create_backbone("mvitv2_small")``: skinjax's feature width, 34.1 M
    parameters under timm's names, and the 16 blocks' (heads, Nq, Nk) read
    from the tower built on the meta device (shapes only)."""
    tower, feat = create_backbone("mvitv2_small", device="meta")
    assert feat == mvit.FEATURE_DIM == jax_backbones._REGISTRY["mvitv2_small"][1] == 768
    assert sum(p.numel() for p in tower.parameters()) == 34_101_216
    blocks = [(b.attn.num_heads, b.attn.q_size[0] * b.attn.q_size[1],
               b.attn.k_size[0] * b.attn.k_size[1])
              for stage in tower.stages for b in stage.blocks]
    assert blocks == PUBLISHED_BLOCKS
    assert all(b.attn.proj.in_features // b.attn.num_heads == 96
               for stage in tower.stages for b in stage.blocks)
    names = [n for n, _ in tower.named_parameters()]
    assert names[:2] == ["patch_embed.proj.weight", "patch_embed.proj.bias"]
    assert names[-2:] == ["norm.weight", "norm.bias"]
    assert "stages.1.blocks.0.shortcut_proj_attn.weight" in names
    with pytest.raises(ValueError, match="224x224"):
        mvit.MViTv2((8, 16, 32, 64), (1, 1, 1, 1), img_size=224)(torch.zeros(1, 64, 64, 3))


@functools.lru_cache(maxsize=None)
def _jax_masks():
    """skinjax's trainable mask in each mode over a narrow MViTv2 (dims (8,
    16, 32, 64)) at the published depth on 32×32 images, read inside
    ``jax.eval_shape`` of ``init``, where the parameter dicts still keep
    creation order (the freeze policy's "last layer" reads it; the traced
    output's dicts come back sorted). Returns {mode: {state_dict key: flag}}."""
    model = jax_mvit.MViTv2(dims=(8, 16, 32, 64))
    masks = {}

    def init(key, x):
        params = model.init(key, x)["params"]
        for mode in FREEZE_MODES:
            flags = jax_trainable_mask({"image_encoder": params}, mode)["image_encoder"]
            arrays = jax.tree_util.tree_map(lambda f, p: np.full(p.shape, f), flags, params)
            sd = state_dict_from_flax({"image_encoder": arrays}, {})
            assert all(v.all() or not v.any() for v in sd.values())
            masks[mode] = {k: bool(v.all()) for k, v in sd.items()}
        return params

    jax.eval_shape(init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    return masks


@pytest.mark.parametrize("mode", FREEZE_MODES)
def test_freeze_policy_selects_skinjax_parameters(mode):
    """skinjax's trainable set, mapped through state_dict_from_flax's key
    map, is the port's in each mode at the published depth: "partial" trains
    no MViT parameter (no last-stage marker matches its names), "last layer"
    the final norm. The port's tower is shapes only."""
    want = _jax_masks()[mode]
    holder = nn.Module()
    holder.image_encoder = mvit.MViTv2((8, 16, 32, 64), img_size=32, device="meta")
    got = {k: on for k, on in trainable_mask(holder, mode).items()}
    assert set(got) == set(want)
    assert got == want
    expect = {"unfrozen_weights": len(got), "frozen_weights": 0, "partial": 0,
              "last_layer_unfrozen_weights": 2}[mode]
    assert sum(got.values()) == expect
