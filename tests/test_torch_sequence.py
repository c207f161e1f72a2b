"""Sequence fusion and the towers' ``tokens=True`` output against skinjax's:
small ViT, BEiT and MViTv2 towers' token outputs; ``SequenceFusionModel`` on
a small ViT registered in both backbone registries, through
``state_dict_from_flax``, in eval mode and its gradients at dropout 0, with
its self-attentions on the K12 route and its cross-attentions on the plain
one. fp32 at atol/rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skinjax.models.backbones as jax_backbones
import skinjax_torch.models.backbones as port_backbones
from skinjax.models.backbones.beit import Beit as JaxBeit
from skinjax.models.backbones.mvit import MViTv2 as JaxMViT
from skinjax.models.backbones.vit import ViT as JaxViT
from skinjax.models.fusion.sequence import SequenceFusionModel as JaxSequence
from skinjax_torch.models.backbones import beit, mvit, vit
from skinjax_torch.models.fusion.sequence import SequenceFusionModel
from skinjax_torch.models.weights import encoder_state_dict, load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import attention as tattn
from tests.test_torch_blocks import randomize
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
HW = 32
TOWERS = {  # name: (skinjax tower, port tower)
    "vit": (lambda: JaxViT(dim=32, depth=1, num_heads=2),
            lambda: vit.VisionTransformer(32, 1, 2, img_size=HW)),
    "beit": (lambda: JaxBeit(dim=32, depth=1, num_heads=2),
             lambda: beit.Beit(32, 1, 2, img_size=HW)),
    "mvit": (lambda: JaxMViT(dims=(16, 32), depths=(1, 1), heads=(1, 2)),
             lambda: mvit.MViTv2((16, 32), (1, 1), (1, 2), img_size=HW)),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_tokens_match_skinjax(tower):
    jax_ctor, port_ctor = TOWERS[tower]
    x = np.random.default_rng(0).normal(size=(2, HW, HW, 3)).astype(np.float32)
    jmod = jax_ctor()
    params = randomize(jmod.init(jax.random.key(0), x)["params"], 1)
    port = load_numpy_state_dict(port_ctor(), encoder_state_dict(params)).eval()
    want = np.asarray(jmod.apply({"params": params}, x, tokens=True))
    with torch.no_grad():
        got = port(torch.from_numpy(x), tokens=True).numpy()
        pooled = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(pooled, np.asarray(jmod.apply({"params": params}, x)), **TOL)


@pytest.fixture
def small_vit(monkeypatch):
    """A width-32 ViT as ``vit-seq-test`` in both registries, for one test."""
    monkeypatch.setitem(jax_backbones._REGISTRY, "vit-seq-test", (
        lambda name=None, dtype=None, common_dim=512: JaxViT(dim=32, depth=1, num_heads=2,
                                                             dtype=dtype), 32))
    monkeypatch.setitem(port_backbones._REGISTRY, "vit-seq-test", (
        lambda device=None: vit.VisionTransformer(32, 1, 2, img_size=HW, device=device), 32))


CFG = dict(num_classes=4, num_heads=2, cnn_model_name="vit-seq-test", common_dim=16,
           vocab_size=10, meta_tokens=2)


def _pair(dropout, seed):
    jmodel = JaxSequence(**CFG, dropout_rate=dropout)
    variables = jax_variables(jmodel, (HW, HW), CFG["vocab_size"], seed)
    port = SequenceFusionModel(**CFG, dropout_rate=dropout)
    load_numpy_state_dict(port, state_dict_from_flax(variables["params"], {}))
    rng = np.random.default_rng(seed + 1)
    img = rng.normal(size=(3, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(3, CFG["vocab_size"])).astype(np.float32)
    return jmodel, variables, port, img, meta


def test_sequence_fusion_matches_skinjax(small_vit, monkeypatch):
    jmodel, variables, port, img, meta = _pair(0.5, 2)
    routes = []
    route = tattn.route
    monkeypatch.setattr(tattn, "route", lambda *a: routes.append((a[:2], route(*a))) or route(*a))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(variables, img, meta)), **TOL)
    # the two self-attentions on K12, the cross-attentions plain
    assert routes == [((5, 5), "k12"), ((2, 2), "k12"), ((5, 2), "plain"), ((2, 5), "plain")]


def test_sequence_fusion_gradients_match_skinjax_at_dropout_0(small_vit):
    jmodel, variables, port, img, meta = _pair(0.0, 4)
    w = np.random.default_rng(5).normal(size=(3, CFG["num_classes"])).astype(np.float32)

    def loss(p, m):
        return (jmodel.apply({"params": p}, img, m, train=True) * w).sum()

    gp, gm = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jnp.asarray(meta))
    m = torch.from_numpy(meta).requires_grad_(True)
    (port.train()(torch.from_numpy(img), m) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(gm), **TOL)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, gp), {})
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **TOL, err_msg=name)
