"""The port's Swin against skinjax's ``transformer_zoo.Swin``: a small Swin
(dims (32, 64), depths (2, 2), heads (1, 2), window 7, 56×56 images: stage 0
a 14×14 map of 2×2 windows whose odd block shifts with the −100 mask, stage 1
a 7×7 map that one window covers, so it does not shift), weights drawn on
skinjax's tree and carried across by ``state_dict_from_flax``. The
converter's round trip through ``import_swin``; the port's three window
attention routes (K7 on the map, K7's padded entry, the plain einsum)
against skinjax's XLA route, forward and every gradient in fp32 (the padded
entry is held against skinjax's padded Pallas kernel in
``tests/test_torch_window_attention.py``); the RG-ATT model around the tower; the
copies of the static mask and the relative-position index; and, on the
published ``swin_tiny_patch4_window7_224`` (shapes only), the parameter
count, the keys and the freeze policy in every mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn
from torch import nn

import skinjax.models.backbones as jax_backbones
import skinjax_torch.models.backbones as port_backbones
from skinjax.models import MultimodalModel as JaxModel
from skinjax.models.backbones import transformer_zoo as jzoo
from skinjax.models.torch_import import import_swin
from skinjax.train.optimizer import trainable_mask as jax_trainable_mask
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.backbones import create_backbone, swin
from skinjax_torch.models.weights import load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import global_attention as tga
from skinjax_torch.ops import window_attention as twa
from skinjax_torch.train.optimizer import FREEZE_MODES, trainable_mask
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

KW = dict(dims=(32, 64), depths=(2, 2), heads=(1, 2), window=7)
HW = 56
ROUTES = {"strip": dict(fused_attn=False, strip_attn=True),
          "padded": dict(fused_attn=True, strip_attn=False),
          "plain": dict(fused_attn=False, strip_attn=False)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(rng):
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return leaf


@functools.lru_cache(maxsize=None)
def _jax_swin():
    """skinjax's small Swin on its XLA route, random fp32 parameters drawn
    with numpy on its eval_shape tree (the rel-pos tables at 0.1, not their
    zero init), an input and a cotangent; y and the parameter gradients of
    sum(y·dy), jitted once."""
    module = jzoo.Swin(**KW, fused_attn=False, strip_attn=False)
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, HW, HW, 3)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(_leaf(rng), dict(shapes))
    x = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    dy = rng.normal(size=(2, HW // 8, HW // 8, KW["dims"][-1])).astype(np.float32)

    def loss(p):
        y = module.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(y * dy), y

    (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return params, x, dy, np.asarray(y), grads


def _to_port(tree):
    """A skinjax Swin tree as the port tower's state_dict (the converter)."""
    sd = state_dict_from_flax({"image_encoder": tree}, {})
    return {k[len("image_encoder."):]: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def _port(route, params):
    port = swin.Swin(*KW.values(), **ROUTES[route])
    port.load_state_dict(_to_port(params))
    return port


def test_converts_both_ways():
    """skinjax's tree → state_dict_from_flax → timm keys (the port's, every
    one) → import_swin → the same tree, leaf for leaf."""
    params = _jax_swin()[0]
    sd = state_dict_from_flax({"image_encoder": params}, {})
    port_keys = {f"image_encoder.{k}" for k in swin.Swin(*KW.values()).state_dict()}
    assert set(sd) == port_keys
    back = import_swin({k: np.asarray(v) for k, v in sd.items()}, KW["dims"], KW["depths"],
                       prefix="image_encoder.")
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", list(ROUTES))
def test_forward_and_gradients_match_skinjax(route):
    """The port's tower on each route against skinjax's XLA route, fp32: y
    (the pooled feature against the mean of skinjax's normed map) within
    1e-4, and every parameter gradient of sum(map·dy) (the gradient tree
    converted as the weights are) within 1e-4 of max(1, |g|). The kernels'
    wrappers launched nothing (CPU tensors take the twins); the strip route
    ran K7's twin 4 times, the padded route its forward and the masked
    recompute core's twins 4 times each."""
    params, x, dy, y_ref, g_ref = _jax_swin()
    port = _port(route, params)
    twa.reset_launches()
    tga.reset_launches()
    calls = {"window_attention_fwd": 0, "window_attention_pad_fwd": 0, "window_core_bwd": 0}
    originals = {name: getattr(twa if name != "window_core_bwd" else tga, name)
                 for name in calls}

    def counting(name):
        def f(*a):
            calls[name] += 1
            return originals[name](*a)
        return f

    for name in calls:
        setattr(twa if name != "window_core_bwd" else tga, name, counting(name))
    try:
        feats = {}
        port.norm.register_forward_hook(lambda m, i, o: feats.setdefault("map", o))
        y = port(torch.tensor(x))
        feats["map"].backward(torch.tensor(dy))
    finally:
        for name, fn in originals.items():
            setattr(twa if name != "window_core_bwd" else tga, name, fn)
    assert sum(twa.LAUNCHES.values()) == sum(tga.LAUNCHES.values()) == 0
    n = sum(KW["depths"])
    assert calls == {"window_attention_fwd": n * (route == "strip"),
                     "window_attention_pad_fwd": n * (route == "padded"),
                     "window_core_bwd": n * (route == "padded")}
    np.testing.assert_allclose(y.detach().numpy(), y_ref.mean(axis=(1, 2)), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(feats["map"].detach().numpy(), y_ref, atol=1e-4, rtol=1e-4)
    want = _to_port(g_ref)
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    for k, p in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=k)


def test_rgatt_model_matches_skinjax(monkeypatch):
    """The RG-ATT multimodal model around the small Swin, registered under a
    test name in both registries: skinjax's random tree → the port (strict
    load) → fp32 logits within 1e-4 (skinjax pools its normed map, the port's
    tower returns the pooled feature)."""
    name = "swin-small-test"
    monkeypatch.setitem(jax_backbones._REGISTRY, name, (
        lambda name=None, dtype=None, common_dim=512: jzoo.Swin(**KW, dtype=dtype), 64))
    monkeypatch.setitem(port_backbones._REGISTRY, name, (
        lambda device=None: swin.Swin(*KW.values(), device=device), 64))
    cfg = dict(num_classes=5, num_heads=4, cnn_model_name=name, common_dim=32,
               text_encoder_dim_output=32, vocab_size=9,
               attention_mechanism="att-intramodal+residual+cross-attention-metadados")
    model = JaxModel(**cfg)
    variables = jax_variables(model, (HW, HW), cfg["vocab_size"], seed=2)
    port = load_numpy_state_dict(MultimodalModel(**cfg),
                                 state_dict_from_flax(variables["params"], {})).eval()
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(2, cfg["vocab_size"])).astype(np.float32)
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    ref = np.asarray(jax.jit(model.apply)(variables, img, meta))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("H,shift", [(14, 3), (28, 3), (56, 3)])
def test_static_mask_and_index_copies(H, shift):
    """The port's copies of skinjax's shifted-window mask and of its
    relative-position index map are equal to skinjax's."""
    np.testing.assert_array_equal(swin.swin_attn_mask(H, H, 7, shift),
                                  jzoo._swin_attn_mask(H, H, 7, shift))
    table = np.arange(13 * 13, dtype=np.float32).reshape(13 * 13, 1)
    gathered = _RelBias(32, 1, 7).apply({"params": {"rel_bias": jnp.asarray(table)}})
    np.testing.assert_array_equal(table[swin.relative_position_index(7)], np.asarray(gathered))


class _RelBias(jzoo.WindowAttention):
    """skinjax's window attention's (N, N, h) bias gathered from its table."""

    @flax_nn.compact
    def __call__(self):
        return self._rel_bias(self.num_heads)


@functools.lru_cache(maxsize=None)
def _jax_published():
    """skinjax's swin_tiny at full width, traced once by ``jax.eval_shape`` of
    ``init``: its parameter shapes, and its trainable mask in each mode as
    {state_dict key: flag}, read inside the trace (creation order)."""
    module = jax_backbones._REGISTRY["swin_tiny_patch4_window7_224"][0]("swin")
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

    return jax.eval_shape(init, jax.random.key(0), jnp.zeros((1, 224, 224, 3))), masks


def test_published_model():
    """``create_backbone("swin_tiny_patch4_window7_224")`` on the meta
    device: skinjax's feature width and parameter count (27,519,354), and
    under timm's names the keys skinjax's tree converts to."""
    tower, feat = create_backbone("swin_tiny_patch4_window7_224", device="meta")
    assert feat == jax_backbones._REGISTRY["swin_tiny_patch4_window7_224"][1] == 768
    shapes, masks = _jax_published()
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in tower.parameters()) == jax_count == 27_519_354
    assert set(masks["unfrozen_weights"]) == {f"image_encoder.{k}" for k in tower.state_dict()}


@pytest.mark.parametrize("mode", FREEZE_MODES)
def test_freeze_policy_selects_skinjax_parameters(mode):
    """skinjax's trainable set, through state_dict_from_flax's key map, is
    the port's in each mode on swin_tiny: no "partial" marker of skinjax's
    names a Swin parameter (nothing trains), and the last layer is the final
    norm."""
    want = _jax_published()[1][mode]
    holder = nn.Module()
    holder.image_encoder = create_backbone("swin_tiny_patch4_window7_224", device="meta")[0]
    got = trainable_mask(holder, mode)
    assert got == want
    on = {k for k, v in got.items() if v}
    if mode == "partial":
        assert not on
    if mode == "last_layer_unfrozen_weights":
        assert on == {"image_encoder.norm.weight", "image_encoder.norm.bias"}


def test_bad_maps_raise():
    with pytest.raises(ValueError, match="multiples of the window"):
        swin.Swin(*KW.values())(torch.zeros(1, 60, 60, 3))
