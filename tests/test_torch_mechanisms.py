"""All eighteen fusion mechanisms of the port against the JAX model, at a
small width (ResNet-18 at 32×32, common_dim 32, a 24-wide metadata tower):
the same weights on both sides (the JAX model's tree, drawn from a seed →
state_dict_from_flax → a strict load into the port), the same numpy inputs.
Also K4's plain twin against skinjax's Pallas kernel (interpret mode), the
fused engine's two K4 routes against skinjax's fused engine, and three Adam
steps of two mechanisms against skinjax's train step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from skinjax.models import MultimodalModel as JaxModel
from skinjax.ops.pallas import fusion_kernels as jfk
from skinjax.serve.engine import InferenceEngine as JaxEngine
from skinjax.train import steps as jsteps
from skinjax.train.optimizer import make_optimizer as jax_make_optimizer
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.fusion.multimodal import _RGATT, MECHANISMS
from skinjax_torch.models.weights import load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import fusion_kernels as fk
from skinjax_torch.serve.engine import FUSED_MECHANISMS, InferenceEngine
from skinjax_torch.train.loop import TrainConfig, build_state
from skinjax_torch.train.steps import make_train_step_weighted
from tests.test_torch_train import LR, WD, _assert_adam_close, jax_without_dropout  # noqa: F401
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

CFG = dict(num_classes=4, num_heads=4, cnn_model_name="resnet-18", common_dim=32,
           text_encoder_dim_output=24, vocab_size=7)
B, HW, STEPS = 2, 32, 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(mech, dropout_rate=0.5):
    """The JAX model, its random variables and the port model holding them."""
    cfg = dict(CFG, attention_mechanism=mech, dropout_rate=dropout_rate)
    jmodel = JaxModel(**cfg)
    variables = jax_variables(jmodel, (HW, HW), CFG["vocab_size"], seed=1)
    port = MultimodalModel(**cfg)
    # strict: the port holds exactly the submodules flax creates for the mechanism
    load_numpy_state_dict(port, state_dict_from_flax(variables["params"],
                                                     variables["batch_stats"]))
    return jmodel, variables, port


def _inputs(seed, n=B):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(n, CFG["vocab_size"])).astype(np.float32)
    u8 = rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
    return img, meta, u8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_metablock_film_twin_matches_skinjax_kernel(dtype):
    """Vd ≠ Du, random biases and LN affines; fp32 within 1e-5, bf16 within
    2 ulps of the output (both round once, from fp32 values that agree to
    rounding)."""
    rng = np.random.default_rng(3)
    n, du, vd = 3, 24, 40
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    v = torch.from_numpy(rng.normal(size=(n, vd)).astype(np.float32)).to(tdt)
    u = torch.from_numpy(rng.normal(size=(n, du)).astype(np.float32)).to(tdt)

    def vec(base):
        return (base + 0.1 * rng.normal(size=vd)).astype(np.float32)

    weights = []
    for _ in range(2):  # (W, b, gamma, beta) of fb, then of gb
        weights += [(rng.normal(size=(du, vd)) / np.sqrt(du)).astype(np.float32),
                    vec(0.0), vec(1.0), vec(0.0)]
    ref = jfk.metablock_film(jnp.asarray(v.float().numpy(), jdt),
                             jnp.asarray(u.float().numpy(), jdt),
                             *[jnp.asarray(w) for w in weights])
    assert ref.dtype == jdt
    ref = np.asarray(ref.astype(jnp.float32))
    out = fk.metablock_film(v, u, *[torch.from_numpy(w) for w in weights])
    assert out.dtype == tdt and out.shape == (n, vd)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
        assert (np.abs(out - ref) <= 2 * ulp).all(), float(np.abs(out - ref).max())


@pytest.mark.parametrize("mech", MECHANISMS)
def test_mechanism_logits_match_jax(mech):
    jmodel, variables, port = _models(mech)
    img, meta, _ = _inputs(0)
    ref = np.asarray(jmodel.apply(variables, img, meta))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    # tests/test_torch_slice.py's tolerance: fp32 convs summed in another order
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("mech", ["metablock", _RGATT + "+metablock"])
def test_k4_routes_match_skinjax_fused_engine(mech):
    """metablock: K4 on the raw tower features (V 512 wide, U 24), K3 on its
    head; …+metablock: the RG-ATT chain, K4 on the cross-attended pair, one
    linear layer."""
    jmodel, variables, port = _models(mech)
    _, meta, u8 = _inputs(1, n=3)
    ref = JaxEngine(jmodel, variables, use_fused=True).predict_probs(u8, meta)
    assert mech in FUSED_MECHANISMS
    fk.reset_launches()
    engine = InferenceEngine(port, use_fused=True, device="cpu")
    assert engine.fused
    out = engine.predict_probs(u8, meta)
    assert sum(fk.LAUNCHES.values()) == 0  # CPU tensors take the plain twins
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("mech", ["metablock", _RGATT + "+att-intramodal+residual"])
def test_train_steps_match_skinjax(jax_without_dropout, mech):  # noqa: F811
    """Three weighted-CE Adam steps, fp32, augmentation and dropout off, from
    the same weights. ``metablock`` holds an image projector its loss never
    reaches: JAX gives it a zero gradient and L2 decay moves it, and so does
    the port. ``…+att-intramodal+residual`` calls its self-attention and
    residual modules twice, so their gradients add up from both calls."""
    jmodel, variables, _ = _models(mech, dropout_rate=0.0)
    port = MultimodalModel(**CFG, attention_mechanism=mech, dropout_rate=0.0)
    load_numpy_state_dict(port, state_dict_from_flax(variables["params"],
                                                     variables["batch_stats"]))
    for m in port.modules():
        if isinstance(m, nn.Dropout):  # the gated residual blocks' 0.1, the metablock head's 0.3
            m.p = 0.0
    rng = np.random.default_rng(21)
    n = 8
    imgs = rng.integers(0, 256, (STEPS, n, HW, HW, 3), dtype=np.uint8)
    metas = rng.normal(size=(STEPS, n, CFG["vocab_size"])).astype(np.float32)
    labels = rng.integers(0, CFG["num_classes"], (STEPS, n)).astype(np.int32)
    cw = rng.uniform(0.5, 2.0, CFG["num_classes"]).astype(np.float32)

    tx = jax_make_optimizer(LR, WD)
    jstep = jsteps.make_train_step_weighted(jmodel, tx, "weighted_ce", augment=False,
                                            image_dtype=jnp.float32)
    params = variables["params"]
    jstate = jsteps.TrainState(params=params, batch_stats=variables["batch_stats"],
                               opt_state=tx.init(params), step=jnp.asarray(0, jnp.int32))
    state = build_state(port, TrainConfig(device="cpu", learning_rate=LR, weight_decay=WD))
    step = make_train_step_weighted(augment=False, image_dtype=torch.float32)
    jax_losses, port_losses, after = [], [], []
    for s in range(STEPS):
        jstate, loss = jstep(jstate, jnp.asarray(imgs[s]), jnp.asarray(metas[s]),
                             jnp.asarray(labels[s]), jax.random.key(0),
                             jnp.asarray(cw))
        jax_losses.append(float(loss))
        port_losses.append(float(step(state, torch.from_numpy(imgs[s]),
                                      torch.from_numpy(metas[s]),
                                      torch.from_numpy(labels[s]), 0, torch.from_numpy(cw))))
        ref = state_dict_from_flax(jstate.params, jstate.batch_stats)
        got = {k: p.detach().numpy().copy() for k, p in port.named_parameters()}
        after.append((got, {k: ref[k] for k in got}))
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=2e-5)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-3)
    # every parameter moved, metablock's unread image projector included
    start = state_dict_from_flax(params, variables["batch_stats"])
    got, ref = after[-1]
    assert all(not np.array_equal(got[k], start[k]) for k in got)
    # step 1 from identical weights: each element moves by ±lr, the same way
    # on both sides but where a gradient near 0 takes the other sign
    _assert_adam_close(*after[0], steps=1, far_share=1e-4, near=0.01 * LR)
    # after three steps such flips have compounded (metablock: 1.3e-3 of the
    # elements past lr, all in the backbone, whose gradients through the FiLM
    # are small): the hard bound is 2·lr a step, the bulk within lr
    _assert_adam_close(got, ref, steps=STEPS, far_share=3e-3, near=LR)
