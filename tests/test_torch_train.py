"""The port's train step against skinjax's: the same weights on both sides
(port init → state_dict → import_multimodal_checkpoint), the same uint8
batches, three weighted-CE Adam steps each, fp32, augmentation off, dropout 0
on both sides (the frameworks cannot share dropout streams). Also the eval
step, the losses and the freeze masks."""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from skinjax.models import MultimodalModel as JaxModel
from skinjax.models.torch_import import filter_to_template, import_multimodal_checkpoint
from skinjax.train import losses as jl
from skinjax.train import steps as jsteps
from skinjax.train.optimizer import make_optimizer as jax_make_optimizer
from skinjax.train.optimizer import trainable_mask as jax_trainable_mask
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.weights import init_weights
from skinjax_torch.train import losses as tl
from skinjax_torch.train.loop import TrainConfig, build_state
from skinjax_torch.train.optimizer import FREEZE_MODES, trainable_mask
from skinjax_torch.train.steps import (
    make_eval_step,
    make_loss_eval_step,
    make_train_step,
    make_train_step_weighted,
)
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

RGATT = "att-intramodal+residual+cross-attention-metadados"
CFG = dict(num_classes=5, num_heads=4, cnn_model_name="resnet-18", common_dim=32,
           text_encoder_dim_output=32, vocab_size=9, attention_mechanism=RGATT)
B, HW, STEPS, LR, WD = 8, 32, 3, 3e-4, 1e-4  # LR: 6× the flagship's


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes,
    and PyTorch's default of a thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_model():
    """Seeded port weights with random biases, norm affines and BatchNorm
    running statistics, so every term of the step matters; dropout 0."""
    model = init_weights(MultimodalModel(**CFG, dropout_rate=0.0), seed=11)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def to_jax_trees(state_dict, template):
    sd = {k: v.detach().numpy().copy() for k, v in state_dict.items()}
    params, stats = import_multimodal_checkpoint(sd, common_dim=CFG["common_dim"],
                                                 backbone=CFG["cnn_model_name"])
    return (filter_to_template(params, template["params"]),
            filter_to_template(stats, template["batch_stats"]))


def jax_template(model):
    return jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, HW, HW, 3)),
                          jnp.zeros((1, CFG["vocab_size"])))


@pytest.fixture
def jax_without_dropout(monkeypatch):
    """skinjax's gated residual blocks carry a fixed 0.1 dropout in train
    mode; replace flax's Dropout by the identity for the test, and drop the
    train steps traced meanwhile from skinjax's step cache."""

    class Identity(flax.linen.Dropout):
        def __call__(self, inputs, deterministic=None, rng=None):
            return inputs

    monkeypatch.setattr(flax.linen, "Dropout", Identity)
    before = set(jsteps._TRAIN_STEP_CACHE)
    yield
    for key in set(jsteps._TRAIN_STEP_CACHE) - before:
        del jsteps._TRAIN_STEP_CACHE[key]


def _batches():
    rng = np.random.default_rng(21)
    imgs = rng.integers(0, 256, (STEPS, B, HW, HW, 3), dtype=np.uint8)
    metas = rng.normal(size=(STEPS, B, CFG["vocab_size"])).astype(np.float32)
    labels = rng.integers(0, CFG["num_classes"], (STEPS, B)).astype(np.int32)
    cw = rng.uniform(0.5, 2.0, CFG["num_classes"]).astype(np.float32)
    return imgs, metas, labels, cw


def _assert_adam_close(port, ref, steps, far_share, near):
    diffs = {k: np.abs(port[k] - ref[k]) for k in ref}
    worst = max(float(d.max()) for d in diffs.values())
    assert worst <= 2 * steps * LR * (1 + 1e-3), (worst / LR, "lr")
    far = sum(int((d > near).sum()) for d in diffs.values())
    total = sum(d.size for d in diffs.values())
    assert far <= far_share * total, (far, total)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mode", ["unfrozen_weights", "frozen_weights"])
def test_train_steps_match_skinjax(jax_without_dropout, mode):
    imgs, metas, labels, cw = _batches()
    port = port_model()
    jmodel = JaxModel(**CFG, dropout_rate=0.0)
    template = jax_template(jmodel)
    params, stats = to_jax_trees(port.state_dict(), template)

    # ---- skinjax: its own weighted train step and masked optimizer ---------
    mask = jax_trainable_mask(template["params"], mode)
    mask = None if mode == "unfrozen_weights" else mask
    tx = jax_make_optimizer(LR, WD, mask=mask)
    jstep = jsteps.make_train_step_weighted(jmodel, tx, "weighted_ce", augment=False,
                                            image_dtype=jnp.float32, trainable_mask=mask)
    jstate = jsteps.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                               step=jnp.asarray(0, jnp.int32))
    jax_losses, jax_stats1, jax_params1 = [], None, None
    for s in range(STEPS):
        jstate, loss = jstep(jstate, jnp.asarray(imgs[s]), jnp.asarray(metas[s]),
                             jnp.asarray(labels[s]), jax.random.key(0), jnp.asarray(cw))
        jax_losses.append(float(loss))
        if s == 0:
            jax_stats1, jax_params1 = _leaves(jstate.batch_stats), _leaves(jstate.params)
    jax_params = _leaves(jstate.params)

    # ---- the port -----------------------------------------------------------
    state = build_state(port, TrainConfig(device="cpu", learning_rate=LR, weight_decay=WD,
                                          unfreeze_weights=mode))
    encoder0 = {k: v.detach().clone() for k, v in port.image_encoder.named_parameters()}
    step = make_train_step_weighted(augment=False, image_dtype=torch.float32)
    port_losses, port_stats1, port_params1 = [], None, None
    for s in range(STEPS):
        loss = step(state, torch.from_numpy(imgs[s]), torch.from_numpy(metas[s]),
                    torch.from_numpy(labels[s]), 0, torch.from_numpy(cw))
        port_losses.append(float(loss))
        if s == 0:
            params1, stats1 = to_jax_trees(port.state_dict(), template)
            port_params1, port_stats1 = _leaves(params1), _leaves(stats1)
    assert state.step == STEPS
    port_params = _leaves(to_jax_trees(port.state_dict(), template)[0])

    # step 1 runs on identical weights: forward-level agreement
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=2e-5)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-3)
    # BatchNorm statistics after step 1 (flax's biased variance; torch's
    # unbiased one is n/(n-1) larger: 8/7 at layer4's 1×1 maps, and even at
    # the stem's n = 8·16·16 it moves running_var by 5e-5 relative). The atol
    # covers a running mean near 0: the batch mean of unit-scale activations
    # carries ~1e-6 of fp32 summation noise, times the 0.1 momentum.
    assert set(port_stats1) == set(jax_stats1)
    for k in jax_stats1:
        np.testing.assert_allclose(port_stats1[k], jax_stats1[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # Adam moves each parameter by ±lr on its first step (m̂/√v̂ = sign(g)),
    # so from identical weights an element differs by 0, or by 2·lr where
    # fp32 noise gave a near-zero gradient the other sign. The bulk must
    # agree: a wrong lr, a missing bias correction or decoupled instead of
    # L2 decay (the attention's zero-gradient q/k rows then stay put instead
    # of moving by lr) moves far more than 1e-4 of the elements.
    assert set(port_params) == set(jax_params) == set(port_params1)
    _assert_adam_close(port_params1, jax_params1, steps=1, far_share=1e-4, near=0.01 * LR)
    # Flips compound over steps: after three, a few elements in millions
    # drift past 3·lr (3.19·lr at most, measured with one CPU thread), so the
    # hard bound is 2·lr per step and the bulk is held within lr.
    _assert_adam_close(port_params, jax_params, steps=STEPS, far_share=1e-3, near=LR)
    if mode == "frozen_weights":
        for k, v in port.image_encoder.named_parameters():
            assert torch.equal(v, encoder0[k]), k
        frozen = [k for k in jax_params if "image_encoder" in k]
        for k in frozen:
            np.testing.assert_array_equal(jax_params[k], _leaves(params)[k])
        # BatchNorm statistics still move in train mode
        assert not torch.equal(port.image_encoder.bn1.running_mean,
                               torch.from_numpy(_leaves(stats)["['image_encoder']['stem']['bn']"
                                                                "['mean']"]))


def test_eval_step_matches_skinjax():
    port = port_model()
    jmodel = JaxModel(**CFG)
    template = jax_template(jmodel)
    params, stats = to_jax_trees(port.state_dict(), template)
    rng = np.random.default_rng(22)
    u8 = rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8)
    meta = rng.normal(size=(B, CFG["vocab_size"])).astype(np.float32)
    jstate = jsteps.TrainState(params=params, batch_stats=stats, opt_state=None,
                               step=jnp.asarray(0, jnp.int32))
    ref = np.asarray(jsteps.make_eval_step(jmodel, image_dtype=jnp.float32)(
        jstate, jnp.asarray(u8), jnp.asarray(meta)))
    state = build_state(port, TrainConfig(device="cpu"))
    out = make_eval_step(torch.float32)(state, torch.from_numpy(u8), torch.from_numpy(meta))
    assert out.dtype == torch.float32 and not port.training
    # fp32 convolutions summed in another order
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", ["weighted_ce", "focal", "soft_target"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_skinjax(name, weighted):
    rng = np.random.default_rng(23)
    logits = rng.normal(size=(16, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, 16).astype(np.int32)
    if name == "soft_target":
        labels = rng.dirichlet(np.ones(6), 16).astype(np.float32)
    cw = rng.uniform(0.2, 3.0, 6).astype(np.float32) if weighted else None
    ref = jl.make_loss_fn(name, cw, gamma=1.5)(jnp.asarray(logits), jnp.asarray(labels))
    out = tl.make_loss_fn(name, cw, gamma=1.5)(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(out), float(ref), rtol=2e-6)
    call = tl.weighted_loss(name, 1.5)(torch.from_numpy(logits), torch.from_numpy(labels),
                                       None if cw is None else torch.from_numpy(cw))
    assert float(call) == float(out)


@pytest.mark.parametrize("reduction", ["sum", "none"])
def test_focal_reductions_match_skinjax(reduction):
    rng = np.random.default_rng(24)
    logits = rng.normal(size=(8, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 8).astype(np.int32)
    ref = jl.focal_loss(jnp.asarray(logits), jnp.asarray(labels), gamma=2.0, reduction=reduction)
    out = tl.focal_loss(torch.from_numpy(logits), torch.from_numpy(labels), gamma=2.0,
                        reduction=reduction)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-6)


@pytest.mark.parametrize("mode", FREEZE_MODES)
def test_freeze_masks_match_skinjax(mode):
    """The same number of backbone leaves trainable in each mode (a flax
    ConvBN holds kernel/scale/bias where torch holds conv.weight and the
    BatchNorm's weight/bias)."""
    port = MultimodalModel(**CFG)
    with pytest.raises(ValueError, match="Invalid"):
        trainable_mask(port, "no-such-mode")
    mask = trainable_mask(port, mode)
    port_enc = [v for k, v in mask.items() if k.startswith("image_encoder.")]
    assert all(v for k, v in mask.items() if not k.startswith("image_encoder."))
    if mode == "last_layer_unfrozen_weights":
        # the module that owns the backbone's last parameters, in creation
        # order (the reference unfreezes params[-2:]); skinjax reads the same
        # order from an untransformed init tree, which eval_shape's sorted
        # tree does not keep
        assert [k for k, v in mask.items() if v and k.startswith("image_encoder.")] == [
            "image_encoder.layer4.1.bn2.weight", "image_encoder.layer4.1.bn2.bias"]
        return
    jmask = _leaves(jax_trainable_mask(jax_template(JaxModel(**CFG))["params"], mode))
    jax_enc = [bool(v) for k, v in jmask.items() if k.startswith("['image_encoder']")]
    assert len(port_enc) == len(jax_enc)
    assert sum(port_enc) == sum(jax_enc)


def test_bound_loss_steps_match_the_weighted_ones():
    """make_train_step with the class weights bound in the loss takes the
    same steps as make_train_step_weighted; make_loss_eval_step gives the
    eval step's logits and their loss."""
    imgs, metas, labels, cw = _batches()
    batch = [torch.from_numpy(a[0]) for a in (imgs, metas, labels)]
    cfg = TrainConfig(device="cpu", learning_rate=LR)
    a, b = build_state(port_model(), cfg), build_state(port_model(), cfg)
    weighted = make_train_step_weighted(augment=True, image_dtype=torch.float32)
    bound = make_train_step(tl.make_loss_fn("weighted_ce", cw), augment=True,
                            image_dtype=torch.float32)
    for _ in range(2):
        assert float(weighted(a, *batch, 3, torch.from_numpy(cw))) == float(bound(b, *batch, 3))
    for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()):
        assert torch.equal(x, y)
    loss_fn = tl.make_loss_fn("weighted_ce", cw)
    loss, logits = make_loss_eval_step(loss_fn, torch.float32)(a, *batch)
    assert torch.equal(logits, make_eval_step(torch.float32)(a, *batch[:2]))
    assert float(loss) == float(loss_fn(logits, batch[2]))
