"""The baselines (MD-Net, LiwTERM, MetaNet) against skinjax's on small towers
registered in both backbone registries (a DenseNet of two one-layer blocks,
a width-32 ViT; ResNet-18 as it is), 32×32 images: eval-mode logits through
``state_dict_from_flax``; MD-Net's ``state_dict`` through skinjax's
``import_mdnet``; the trainable set in every freeze mode against skinjax's
(whose mask never reaches a baseline's auto-named tower); ``create_model``'s
choice of tower. fp32 at atol/rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skinjax.models.backbones as jax_backbones
import skinjax_torch.models.backbones as port_backbones
from skinjax.models import baselines as jbase
from skinjax.models.backbones import cnn_zoo as jax_cnn_zoo
from skinjax.models.backbones.vit import ViT as JaxViT
from skinjax.models.torch_import import import_mdnet
from skinjax.train.optimizer import trainable_mask as jax_trainable_mask
from skinjax_torch.models import baselines
from skinjax_torch.models.backbones import cnn_zoo, vit
from skinjax_torch.models.factory import create_model
from skinjax_torch.models.weights import init_weights, load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.train.loop import TrainConfig, build_state
from skinjax_torch.train.optimizer import FREEZE_MODES
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
HW, META, CLASSES = 32, 9, 4
DENSE = dict(block_config=(1, 1), growth_rate=8, init_features=16)  # 20 channels out


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_towers(monkeypatch):
    """The small towers in both registries (and as the factory's default
    DenseNet-169 and ViT-large), for one test."""
    jax_dense = (lambda name=None, dtype=None, common_dim=512:
                 jax_cnn_zoo.DenseNet(**DENSE, dtype=dtype), 20)
    jax_vit = (lambda name=None, dtype=None, common_dim=512:
               JaxViT(dim=32, depth=1, num_heads=2, dtype=dtype), 32)
    port_dense = (lambda device=None: cnn_zoo.DenseNet(**DENSE, device=device), 20)
    port_vit = (lambda device=None: vit.VisionTransformer(32, 1, 2, img_size=HW, device=device),
                32)
    for name in ("densenet-test", "densenet169"):
        monkeypatch.setitem(jax_backbones._REGISTRY, name, jax_dense)
        monkeypatch.setitem(port_backbones._REGISTRY, name, port_dense)
    for name in ("vit-test", "vit_large_patch16_224"):
        monkeypatch.setitem(jax_backbones._REGISTRY, name, jax_vit)
        monkeypatch.setitem(port_backbones._REGISTRY, name, port_vit)


CASES = {  # name: (skinjax model, port model)
    "mdnet": (lambda: jbase.MDNet(num_classes=CLASSES, meta_dim=META, hidden_dim=8,
                                  cnn_model_name="densenet-test"),
              lambda: baselines.MDNet(CLASSES, META, 8, "densenet-test")),
    "liwterm": (lambda: jbase.LiwTERM(num_classes=CLASSES, image_encoder="vit-test"),
                lambda: baselines.LiwTERM(CLASSES, META, "vit-test")),
    "metanet": (lambda: jbase.MetaNetModel(num_classes=CLASSES, image_encoder="resnet-18"),
                lambda: baselines.MetaNetModel(CLASSES, META, "resnet-18")),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, HW, HW, 3)).astype(np.float32),
            rng.normal(size=(3, META)).astype(np.float32))


def _pair(name, seed=0):
    jax_ctor, port_ctor = CASES[name]
    jmodel = jax_ctor()
    variables = jax_variables(jmodel, (HW, HW), META, seed)
    port = load_numpy_state_dict(port_ctor(), state_dict_from_flax(
        variables["params"], variables.get("batch_stats", {})))
    return jmodel, variables, port.eval()


@pytest.mark.parametrize("name", sorted(CASES))
def test_baseline_matches_skinjax(name):
    jmodel, variables, port = _pair(name)
    img, meta = _inputs(1)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(variables, img, meta)), **TOL)


def test_mdnet_state_dict_feeds_import_mdnet():
    jmodel = CASES["mdnet"][0]()
    port = init_weights(CASES["mdnet"][1](), seed=3).eval()
    with torch.no_grad():  # running statistics away from (0, 1)
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert {k.split(".")[0] for k in sd} == {"feature_extractor", "meta_net", "meta_block",
                                             "classifier"}
    assert sd["meta_net.metanet.0.weight"].shape == (8, META, 1, 1)
    params, stats = import_mdnet(sd, block_config=DENSE["block_config"])
    img, meta = _inputs(4)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats}, img, meta))
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # and back: the imported trees convert to the same state_dict
    back = state_dict_from_flax(params, stats)
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")} | {
        k for k in back if k.endswith("num_batches_tracked")}
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k])


def _jax_trainable_scalars(model, mode):
    """skinjax's trainable scalars in ``mode``, its mask taken inside one
    ``eval_shape`` of ``init`` (creation order)."""
    count = {}

    def run():
        params = model.init(jax.random.key(0), jnp.zeros((1, HW, HW, 3)),
                            jnp.zeros((1, META)))["params"]
        mask = jax_trainable_mask(params, mode)
        sizes = jax.tree_util.tree_map(lambda x, m: int(np.prod(x.shape)) * m, params, mask)
        count["n"] = sum(jax.tree_util.tree_leaves(sizes))
        count["all"] = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
        return 0

    jax.eval_shape(run)
    return count["n"], count["all"]


@pytest.mark.parametrize("mode", FREEZE_MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_trainable_set_matches_skinjax(name, mode):
    jax_ctor, port_ctor = CASES[name]
    trainable, total = _jax_trainable_scalars(jax_ctor(), mode)
    assert trainable == total  # skinjax's mask never reaches the baseline's tower
    model = build_state(port_ctor(), TrainConfig(device="cpu", unfreeze_weights=mode)).model
    assert sum(p.numel() for p in model.parameters() if p.requires_grad) == trainable
    assert sum(p.numel() for p in model.parameters()) == total


@pytest.mark.parametrize("name,cnn,cls,tower", [
    ("mdnet", "resnet-18", baselines.MDNet, cnn_zoo.DenseNet),  # DenseNet-169 unless densenet
    ("mdnet", "densenet-test", baselines.MDNet, cnn_zoo.DenseNet),
    ("liwterm", "resnet-18", baselines.LiwTERM, vit.VisionTransformer),  # ViT-large unless vit
    ("liwterm", "vit-test", baselines.LiwTERM, vit.VisionTransformer),
    ("MetaNet", "resnet-18", baselines.MetaNetModel, torch.nn.Module),
])
def test_create_model_builds_the_baselines(name, cnn, cls, tower):
    model = create_model(num_classes=CLASSES, model_name=name, cnn_model_name=cnn,
                         vocab_size=META, seed=0)
    assert isinstance(model, cls)
    if cls is baselines.MDNet:
        assert model.meta_block.fb[0].in_features == META
    else:
        assert isinstance(model.backbone, tower)
    img, meta = _inputs(5)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(img), torch.from_numpy(meta))
    assert out.shape == (3, CLASSES) and bool(torch.isfinite(out).all())
    again = create_model(num_classes=CLASSES, model_name=name, cnn_model_name=cnn,
                         vocab_size=META, seed=0)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  again.state_dict().values()))
