"""The port's CNN zoo against skinjax's ``cnn_zoo``: a narrow tower of each
family (DenseNet, MobileNet-V2, EfficientNet, VGG16, custom-cnn), weights
drawn on skinjax's tree (BatchNorm statistics included) and carried across by
``state_dict_from_flax``. The converter's round trip through
``import_densenet``/``import_mobilenet_v2``/``import_efficientnet``/
``import_vgg16``; the train-mode forward, every parameter gradient and the
running statistics against skinjax in fp32, on both BatchNorm routes (the
native one and K6's, ``fuse_batch_norms``; on the CPU K6's wrappers take their
twins); the RG-ATT model around a tower; and, on the published towers
(shapes only, ``jax.eval_shape``), the parameter count, the keys and the
freeze policy in every mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import skinjax.models.backbones as jax_backbones
from skinjax.models import MultimodalModel as JaxModel
from skinjax.models.backbones import cnn_zoo as jzoo
from skinjax.models.torch_import import (
    import_densenet,
    import_efficientnet,
    import_mobilenet_v2,
    import_vgg16,
)
from skinjax.train.optimizer import trainable_mask as jax_trainable_mask
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.backbones import cnn_zoo, create_backbone
from skinjax_torch.models.weights import load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import batch_norm as tbn
from skinjax_torch.train.optimizer import FREEZE_MODES, trainable_mask
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

HW = 32
ROUTES = ("native", "k6")
NARROW_VGG = (8, 8, "M", 8, 8, "M", 8, 8, 8, "M", 8, 8, 8, "M", 8, 8, 8, "M")
EFFNET_CFG = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 1, 2, 5))
# family -> (skinjax module, the port's tower, importer of a torchvision state_dict)
FAMILIES = {
    "densenet": (lambda: jzoo.DenseNet(block_config=(2, 2), growth_rate=8, init_features=16),
                 lambda: cnn_zoo.DenseNet((2, 2), 8, 16),
                 lambda sd: import_densenet(sd, (2, 2), prefix="image_encoder.")),
    "mobilenet_v2": (lambda: jzoo.MobileNetV2(cfg=((1, 8, 1, 1), (6, 16, 2, 2))),
                     lambda: cnn_zoo.MobileNetV2(((1, 8, 1, 1), (6, 16, 2, 2))),
                     lambda sd: import_mobilenet_v2(sd, ((1, 8, 1, 1), (6, 16, 2, 2)),
                                                    prefix="image_encoder.")),
    "efficientnet": (lambda: jzoo.EfficientNet(width=0.5, depth=1.0, cfg=EFFNET_CFG),
                     lambda: cnn_zoo.EfficientNet(0.5, 1.0, EFFNET_CFG),
                     lambda sd: import_efficientnet(sd, [c[:4] for c in EFFNET_CFG],
                                                    prefix="image_encoder.")),
    "vgg16": (lambda: jzoo.VGG16(cfg=NARROW_VGG), lambda: cnn_zoo.VGG16(NARROW_VGG, 8),
              lambda sd: (import_vgg16(sd, prefix="image_encoder."), {})),
    "custom_cnn": (lambda: jzoo.CustomCNN(common_dim=32), lambda: cnn_zoo.CustomCNN(32), None),
}
BN_FAMILIES = ("densenet", "mobilenet_v2", "efficientnet")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw_variables(module, hw, seed):
    """Random (params, batch_stats) on ``module``'s eval_shape tree, drawn
    with numpy: kernels at fan-in scale, norm scales and running variances
    in [0.5, 1.5], biases and running means near 0."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, hw, hw, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
    return tree["params"], tree.get("batch_stats", {})


def jax_train(module, params, stats, x, dy, train=True):
    """skinjax's tower on x in train mode (``train=False`` where it has no
    BatchNorm and a dropout, VGG16): the output, the parameter gradients of
    sum(out·dy) and the updated statistics, jitted once."""

    def loss(p):
        if not stats:
            y = module.apply({"params": p}, jnp.asarray(x), train=train)
            return jnp.sum(y * dy), (y, {})
        y, upd = module.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, upd["batch_stats"])

    (_, (y, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(y), grads, new_stats


def to_port(params, stats=None, **kw):
    """A skinjax tower's (params, batch_stats) as the port tower's state_dict."""
    sd = state_dict_from_flax({"image_encoder": params},
                              {"image_encoder": stats} if stats is not None else {}, **kw)
    return {k[len("image_encoder."):]: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def port_train(port, route, x, dy):
    """The port's tower in train mode on x (on ``route``'s BatchNorms): the
    output and the backward of sum(out·dy) into the parameters' .grad."""
    if route == "k6":
        tbn.fuse_batch_norms(port)
    port.train()
    y = port(torch.tensor(x))
    y.backward(torch.tensor(dy))
    return y.detach().numpy()


def assert_tower_matches(port, y, y_ref, grads, new_stats, tol=1e-4, **kw):
    """y within tol (and tol·|y|); every parameter gradient within tol of
    max(1, |g|); every running statistic within tol. A gradient below
    1e-3 of the tower's largest is 0 by the math (the bias or BatchNorm
    shift of a layer that a train-mode BatchNorm follows: the batch mean
    takes the constant away), and both sides hold its summation noise: it
    is held within 4e-6 of the tower's largest gradient element (fp32 sums
    of that gradient's scale over the rows)."""
    np.testing.assert_allclose(y, y_ref, atol=tol, rtol=tol)
    want = to_port(grads, new_stats if new_stats else None, **kw)
    got = dict(port.named_parameters())
    assert set(got) | {k for k in want if "running" in k or "batches" in k} == set(want)
    largest = max(float(want[k].abs().max()) for k in got)
    for k, p in got.items():
        w = want[k].numpy()
        atol = tol * max(1.0, np.abs(w).max())
        if np.abs(w).max() < 1e-3 * largest:
            atol = max(atol, 4e-6 * largest)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=atol, rtol=0, err_msg=k)
    buffers = dict(port.named_buffers())
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(buffers[k].numpy(), want[k].numpy(), atol=tol, rtol=tol,
                                       err_msg=k)


@functools.lru_cache(maxsize=None)
def _narrow(family):
    """skinjax's narrow tower of a family: module, drawn variables, an input
    and a cotangent, its train-mode output, gradients and statistics."""
    jmod = FAMILIES[family][0]()
    params, stats = draw_variables(jmod, HW, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    y0 = jax.eval_shape(jmod.apply, {"params": params, "batch_stats": stats} if stats
                        else {"params": params}, jnp.asarray(x))
    dy = rng.normal(size=y0.shape).astype(np.float32)
    y, grads, new_stats = jax_train(jmod, params, stats, x, dy, train=family != "vgg16")
    return params, stats, x, dy, y, grads, new_stats


@pytest.mark.parametrize("family", [f for f in FAMILIES if FAMILIES[f][2] is not None])
def test_converts_both_ways(family):
    """skinjax's tree → state_dict_from_flax → torchvision keys (the port's,
    every one, buffers included) → skinjax's importer → the same
    parameters and statistics, leaf for leaf."""
    params, stats = _narrow(family)[:2]
    sd = state_dict_from_flax({"image_encoder": params}, {"image_encoder": stats})
    assert set(sd) == {f"image_encoder.{k}" for k in FAMILIES[family][1]().state_dict()}
    back_p, back_s = FAMILIES[family][2]({k: np.asarray(v) for k, v in sd.items()})
    for got, want in ((back_p, params), (back_s, stats)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_custom_cnn_converts():
    """custom-cnn (no importer): its two layers under ``conv``/``fc``."""
    params = _narrow("custom_cnn")[0]
    sd = state_dict_from_flax({"image_encoder": params}, {})
    port = cnn_zoo.CustomCNN(32)
    load_numpy_state_dict(port, {k[len("image_encoder."):]: v for k, v in sd.items()})
    np.testing.assert_array_equal(port.conv.weight.detach().numpy(),
                                  np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("family,route", [(f, r) for f in FAMILIES for r in ROUTES
                                          if f in BN_FAMILIES or r == "native"])
def test_forward_and_gradients_match_skinjax(family, route):
    """The port's narrow tower in train mode on each BatchNorm route against
    skinjax's, fp32: the output (the pre-pooling map, or the pooled features
    of VGG16 and custom-cnn) within 1e-4, every parameter gradient of
    sum(out·dy) within 1e-4 of max(1, |g|), the running statistics within
    1e-4. VGG16 runs with its dropout off on both sides (skinjax's
    ``train=False``, the port's p = 0: the masks are drawn differently)."""
    params, stats, x, dy, y_ref, grads, new_stats = _narrow(family)
    port = FAMILIES[family][1]()
    port.load_state_dict(to_port(params, stats if stats else None))
    if family == "vgg16":
        port.classifier[2].p = 0.0
    tbn.reset_launches()
    y = port_train(port, route, x, dy)
    assert tbn.LAUNCHES == {"bn_stats": 0, "bn_grad_stats": 0}  # CPU: the twins
    assert tbn.count_batch_norms(port) == (sum(isinstance(m, nn.BatchNorm2d)
                                               for m in port.modules()) if route == "k6" else 0)
    assert_tower_matches(port, y, y_ref, grads, new_stats)


def test_rgatt_model_matches_skinjax():
    """The RG-ATT multimodal model around custom-cnn, whose feature width is
    common_dim (the registry passes it): skinjax's random tree → the port
    (strict load) → fp32 logits within 1e-4."""
    cfg = dict(num_classes=5, num_heads=4, cnn_model_name="custom-cnn", common_dim=32,
               text_encoder_dim_output=32, vocab_size=9,
               attention_mechanism="att-intramodal+residual+cross-attention-metadados")
    model = JaxModel(**cfg)
    variables = jax_variables(model, (HW, HW), cfg["vocab_size"], seed=2)
    port = load_numpy_state_dict(MultimodalModel(**cfg),
                                 state_dict_from_flax(variables["params"], {})).eval()
    assert port.cnn_dim_output == 32
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(2, cfg["vocab_size"])).astype(np.float32)
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    ref = np.asarray(jax.jit(model.apply)(variables, img, meta))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


PUBLISHED = {"vgg16": 134_260_544, "densenet169": 12_484_480, "mobilenet-v2": 2_223_872,
             "efficientnet-b0": 4_007_548, "efficientnet-b7": 63_786_960, "custom-cnn": 9_152}


@functools.lru_cache(maxsize=None)
def published(name, hw):
    """skinjax's published tower, traced once by ``jax.eval_shape`` of
    ``init`` (nothing drawn): its parameter shapes, and its trainable mask in
    each mode read inside the trace, where the parameter dicts still keep
    creation order, as {mode: {state_dict key: flag}} (each leaf stood in for
    by its flag broadcast to its shape, a view of one element: the
    EfficientNet converter reads the project convs' widths; parameters
    only)."""
    module = jax_backbones.create_backbone(name)[0]
    masks = {}

    def init(key, x):
        params = module.init(key, x)["params"]
        for mode in FREEZE_MODES:
            flags = jax_trainable_mask({"image_encoder": params}, mode)["image_encoder"]
            arrays = jax.tree_util.tree_map(lambda f, p: np.broadcast_to(bool(f), p.shape),
                                            flags, params)
            masks[mode] = {k: bool(v.all()) for k, v in
                           state_dict_from_flax({"image_encoder": arrays}, {}).items()}
        return params

    return jax.eval_shape(init, jax.random.key(0), jnp.zeros((1, hw, hw, 3))), masks


def _hw(name):
    return 224 if name == "vgg16" else 32  # VGG16's fc1 takes the 224×224 map


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_published_model(name):
    """``create_backbone(name)`` on the meta device: skinjax's feature width
    and parameter count, and, under torchvision's names, the parameters
    that skinjax's tree converts to."""
    tower, feat = create_backbone(name, device="meta", common_dim=512)
    assert feat == (jax_backbones._REGISTRY[name][1] or 512)
    shapes, masks = published(name, _hw(name))
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in tower.parameters()) == jax_count == PUBLISHED[name]
    assert set(masks["unfrozen_weights"]) == {f"image_encoder.{k}"
                                              for k, _ in tower.named_parameters()}


@pytest.mark.parametrize("mode", FREEZE_MODES)
@pytest.mark.parametrize("name", list(PUBLISHED))
def test_freeze_policy_selects_skinjax_parameters(name, mode):
    """skinjax's trainable set, mapped through state_dict_from_flax's key
    map, is the port's in each mode on the published tower. "partial":
    skinjax's "layer4" marker takes block{i}_layer4 in every dense block
    (torchvision's denselayer5) with "trans2" and "norm_final"
    (transition3, norm5); "block11" and "head" take MobileNet-V2's
    features.12 and features.18 and EfficientNet's block11 (B0 features.6.0,
    B7 features.3.0), B7's "block23" features.4.5, and the head; nothing in
    VGG16 and custom-cnn. "last layer": the last module skinjax creates."""
    want = published(name, _hw(name))[1][mode]
    holder = nn.Module()
    holder.image_encoder = create_backbone(name, device="meta")[0]
    got = trainable_mask(holder, mode)
    assert got == want
    on = {k.rsplit(".", 1)[0][len("image_encoder."):] for k, v in got.items() if v}
    if mode == "partial" and name == "densenet169":
        assert {k.rsplit(".", 1)[0] for k in on} == {
            *(f"features.denseblock{i}.denselayer5" for i in range(1, 5)),
            "features.transition3", "features"}
    if mode == "partial" and name in ("vgg16", "custom-cnn"):
        assert not on
    if mode == "last_layer_unfrozen_weights":
        assert len(on) == 1
