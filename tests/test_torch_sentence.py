"""The sentence-tower slice of the port against skinjax: a tokens-mode
``MultimodalModel`` (a small ViT image tower, width 32, one block, 32×32, +
a small BERT: 2 layers, width 32, 2 heads, vocab 64, T=16) with skinjax's
weights carried across by ``state_dict_from_flax``, fp32: logits, the
weighted-CE loss and every gradient, through K12's stored-P and recompute
backwards (the latter forced by ``STORE_P_MAX_BYTES = 0``), and the
parameters after one Adam step with the text tower trained and frozen. Then
the freeze policy (skinjax binarises it for a sentence tower), the weights'
conversion both ways, and the entry points: the schema with a ``sentence``
column, ``build_token_source``, ``create_model``'s text route,
``build_sentence_tower`` with and without local weights, and the train CLI
on a sentence dataset, with its checkpoint reloaded."""

import functools
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import skinjax.models.backbones as jax_backbones
import skinjax_torch.models.backbones as port_backbones
from skinjax.data.schemas import prepare_dataset as jax_prepare_dataset
from skinjax.models import MultimodalModel as JaxModel
from skinjax.models.backbones.vit import ViT as JaxViT
from skinjax.models.text.bert import NativeBertEncoder as JBert
from skinjax.models.text.bert import NativeSentenceTower as JTower
from skinjax.models.torch_import import import_multimodal_checkpoint, import_vit
from skinjax.train import experiments as jexp
from skinjax.train import steps as jsteps
from skinjax.train.losses import weighted_loss as jax_weighted_loss
from skinjax.train.optimizer import make_optimizer as jax_make_optimizer
from skinjax.train.optimizer import trainable_mask as jax_trainable_mask
from skinjax_torch.data.fixtures import (
    pad_ufes20_table,
    row_sentences,
    write_pad_ufes20_like,
    write_wordpiece_vocab,
)
from skinjax_torch.data.schemas import prepare_dataset
from skinjax_torch.models import MultimodalModel, factory
from skinjax_torch.models.backbones import vit
from skinjax_torch.models.text import sentence
from skinjax_torch.models.text.bert import NativeBertEncoder, NativeSentenceTower
from skinjax_torch.models.weights import load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import global_attention as tga
from skinjax_torch.train import losses as tl
from skinjax_torch.train.experiments import build_token_source
from skinjax_torch.train.loop import TEXT_PREFIXES, TrainConfig, build_state
from skinjax_torch.train.optimizer import FREEZE_MODES
from skinjax_torch.train.steps import make_eval_step, make_train_step_weighted
from tests.test_torch_train import _assert_adam_close, jax_without_dropout  # noqa: F401
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

RGATT = "att-intramodal+residual+cross-attention-metadados"
BERT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=48, hidden_dropout=0.0, attention_dropout=0.0)
TOWER, DIM, HW = "vit-sentence-test", 32, 32  # 4 patches + CLS
CFG = dict(num_classes=5, num_heads=4, cnn_model_name=TOWER, common_dim=32, vocab_size=9,
           text_model_name="bert-base-uncased", text_input_mode="tokens")
B, T, LR, WD = 4, 16, 3e-4, 1e-4
K12_LAYERS = BERT["num_layers"] + 1  # the BERT layers and the ViT block


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_vit(monkeypatch):
    """A one-block ViT of width 32 as backbone ``TOWER`` in both registries
    and in skinjax's importer; undone after the test."""
    monkeypatch.setitem(jax_backbones._REGISTRY, TOWER, (
        lambda name=None, dtype=None, common_dim=512: JaxViT(dim=DIM, depth=1, num_heads=2,
                                                             dtype=dtype), DIM))
    monkeypatch.setitem(port_backbones._REGISTRY, TOWER, (
        lambda device=None: vit.VisionTransformer(DIM, 1, 2, img_size=HW, device=device), DIM))
    from skinjax.models import torch_import

    importer = torch_import.import_backbone

    def import_backbone(sd, backbone, prefix=""):
        if backbone == TOWER:
            return import_vit(sd, 1, DIM, prefix), {}
        return importer(sd, backbone, prefix)

    monkeypatch.setattr(torch_import, "import_backbone", import_backbone)


def jax_model(mech):
    tower = JTower(encoder=JBert(**BERT), scope_name="bert")
    return JaxModel(**CFG, attention_mechanism=mech, text_module=tower,
                    text_encoder_dim_output=BERT["hidden_size"], dropout_rate=0.0)


def port_model(mech):
    tower = NativeSentenceTower(NativeBertEncoder(**BERT), pool="cls")
    return MultimodalModel(**CFG, attention_mechanism=mech, text_module=tower, dropout_rate=0.0)


def batch(seed=21):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.int32)
    mask[1, 9:] = 0
    mask[3, 4:] = 0
    return (rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8),
            {"input_ids": rng.integers(0, BERT["vocab_size"], (B, T)).astype(np.int32),
             "attention_mask": mask},
            rng.integers(0, CFG["num_classes"], B).astype(np.int32),
            rng.uniform(0.5, 2.0, CFG["num_classes"]).astype(np.float32))


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def _jax_param_shapes(mech):
    """skinjax's parameter tree for ``mech``: ``jax.eval_shape`` of ``init``
    (it traces and compiles nothing; an eager init compiles every op)."""
    _, meta, _, _ = batch()
    return jax.eval_shape(jax_model(mech).init, jax.random.key(0), jnp.zeros((1, HW, HW, 3)),
                          jax.tree_util.tree_map(lambda a: jnp.asarray(a[:1]), meta))["params"]


def _jax_params(mech, seed):
    """Parameters for ``pair`` drawn with numpy from a seed as skinjax's init
    draws them (kernels at fan-in scale, norm scales 1, embeddings at 0.02,
    the rest 0), plus noise at 0.05, so that biases and norms matter."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        base = {"kernel": int(np.prod(s.shape[:-1])) ** -0.5, "embedding": 0.02}.get(name, 0.0)
        a = base * rng.normal(size=s.shape) + 0.05 * rng.normal(size=s.shape)
        return (a + (name == "scale")).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(_jax_param_shapes(mech)))


def pair(mech, seed):
    """skinjax's tokens model with random parameters (its init plus noise,
    so that biases and norms matter) and the port's holding them."""
    jmodel = jax_model(mech)
    params = _jax_params(mech, seed)
    port = load_numpy_state_dict(port_model(mech), state_dict_from_flax(params, {}))
    for m in port.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return jmodel, params, port


def _tmeta(meta):
    return {k: torch.from_numpy(v) for k, v in meta.items()}


def _spy_backwards(monkeypatch):
    """Count the CPU calls of K12's two backwards (the twins run here)."""
    calls = {"global_attention_bwd": 0, "global_attention_bwd_recompute": 0}
    for name in calls:
        fn = getattr(tga, name)

        def spy(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(tga, name, spy)
    return calls


def _grad_batch():
    _, meta, labels, cw = batch()
    return np.random.default_rng(5).normal(size=(B, HW, HW, 3)).astype(np.float32), meta, \
        labels, cw


@functools.lru_cache(maxsize=None)
def _jax_logits_loss_grads(mech):
    """skinjax's side of the gradient test, once a mechanism (the route is
    the port's): eval logits, the train-mode loss and its gradients as a
    state_dict."""
    jmodel, params = jax_model(mech), _jax_params(mech, 1)
    img, meta, labels, cw = _grad_batch()
    jmeta = jax.tree_util.tree_map(jnp.asarray, meta)
    ref = jax.jit(jmodel.apply)({"params": params}, img, jmeta)

    def loss_of(p):
        logits = jmodel.apply({"params": p}, img, jmeta, train=True,
                              rngs={"dropout": jax.random.key(0)})
        return jax_weighted_loss("weighted_ce")(logits, jnp.asarray(labels), jnp.asarray(cw))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    return np.asarray(ref), float(jloss), state_dict_from_flax(jgrads, {})


@pytest.mark.parametrize("route", ["stored", "recompute"])
@pytest.mark.parametrize("mech", [RGATT, "metablock"])
def test_logits_loss_and_gradients_match_skinjax(mech, route, small_vit, jax_without_dropout,
                                                  monkeypatch):
    """fp32, the same weights and inputs: eval logits (1e-4), the train-mode
    weighted-CE loss (2e-5) and the gradient of every parameter (each tensor
    within 1e-3 of its norm plus 1e-6 of all gradients' norm: the key
    biases' gradients are 0 by the math, rounding noise on both sides). The
    attention backward takes the route asked for: stored P, or recompute
    with ``STORE_P_MAX_BYTES`` at 0 (one call a K12 layer either way)."""
    if route == "recompute":
        monkeypatch.setattr(tga, "STORE_P_MAX_BYTES", 0)
    calls = _spy_backwards(monkeypatch)
    _, _, port = pair(mech, seed=1)
    img, meta, labels, cw = _grad_batch()
    ref, jloss, ref_g = _jax_logits_loss_grads(mech)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(img), _tmeta(meta))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)

    port.train()
    loss = tl.weighted_loss("weighted_ce")(port(torch.from_numpy(img), _tmeta(meta)),
                                           torch.from_numpy(labels).long(), torch.from_numpy(cw))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=2e-5)
    want = {"global_attention_bwd": K12_LAYERS * (route == "stored"),
            "global_attention_bwd_recompute": K12_LAYERS * (route == "recompute")}
    assert calls == want

    got = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in port.named_parameters()}
    assert set(got) == set(ref_g)
    assert any(k.startswith("text_encoder.") for k in ref_g)
    g_all = float(np.sqrt(sum(np.square(np.asarray(r, np.float64)).sum()
                              for r in ref_g.values())))
    for k, r in ref_g.items():
        err = float(np.linalg.norm(got[k].numpy() - np.asarray(r)))
        assert err <= 1e-3 * float(np.linalg.norm(r)) + 1e-6 * g_all, (k, err)


@pytest.mark.parametrize("mode", ["unfrozen_weights", "frozen_weights"])
def test_adam_step_matches_skinjax(mode, small_vit, jax_without_dropout, monkeypatch):
    """One weighted-CE Adam step through both train steps (augment off,
    fp32), the recompute route on: the loss, and the parameters after the
    step (Adam's first step is ±lr, so the bulk agrees exactly and a few
    near-zero gradients flip). Under ``frozen_weights`` skinjax binarises
    the freeze for a sentence tower: the whole tower stays bit-identical on
    both sides, with the image encoder."""
    monkeypatch.setattr(tga, "STORE_P_MAX_BYTES", 0)
    jmodel, params, port = pair(RGATT, seed=31)
    imgs, meta, labels, cw = batch(seed=33)

    mask = None
    if mode != "unfrozen_weights":  # skinjax's loop: image mask ∧ binarised text mask
        mask = jax.tree_util.tree_map(
            lambda a, b: a and b, jax_trainable_mask(params, mode),
            jax_trainable_mask(params, "frozen_weights",
                               frozen_prefixes=("text_tower", "text_module")))
    tx = jax_make_optimizer(LR, WD, mask=mask)
    jstep = jsteps.make_train_step_weighted(jmodel, tx, "weighted_ce", augment=False,
                                            image_dtype=jnp.float32, trainable_mask=mask)
    jstate = jsteps.TrainState(params=params, batch_stats={}, opt_state=tx.init(params),
                               step=jnp.asarray(0, jnp.int32))
    jstate, jloss = jstep(jstate, jnp.asarray(imgs), jax.tree_util.tree_map(jnp.asarray, meta),
                          jnp.asarray(labels), jax.random.key(0), jnp.asarray(cw))

    state = build_state(port, TrainConfig(device="cpu", learning_rate=LR, weight_decay=WD,
                                          unfreeze_weights=mode))
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    step = make_train_step_weighted(augment=False, image_dtype=torch.float32)
    loss = step(state, torch.from_numpy(imgs), _tmeta(meta), torch.from_numpy(labels), 0,
                torch.from_numpy(cw))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    want = {k: np.asarray(v) for k, v in state_dict_from_flax(jstate.params, {}).items()}
    got = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    assert set(got) == set(want)
    _assert_adam_close(got, want, steps=1, far_share=1e-4, near=0.01 * LR)
    text = [k for k in want if k.startswith("text_encoder.")]
    assert text
    if mode == "frozen_weights":
        start = state_dict_from_flax(params, {})
        for k in text + [k for k in want if k.startswith("image_encoder.")]:
            assert torch.equal(port.state_dict()[k], before[k]), k
            np.testing.assert_array_equal(want[k], start[k], err_msg=k)
    else:
        assert any(not torch.equal(port.state_dict()[k], before[k]) for k in text)


@pytest.mark.parametrize("mode", FREEZE_MODES)
def test_freeze_policy_is_binarised_for_a_sentence_tower(mode, small_vit, monkeypatch):
    """Without ``text_train_mode``, a tokens model's whole text tower trains
    under ``unfrozen_weights`` and is frozen under every other mode (no
    parameter of it in the optimizer, and no attention backward through its
    layers); the one-hot tower keeps training in every mode; an explicit
    ``text_train_mode`` overrides."""
    calls = _spy_backwards(monkeypatch)
    _, _, port = pair(RGATT, seed=41)
    state = build_state(port, TrainConfig(device="cpu", unfreeze_weights=mode))
    text = [p for n, p in port.named_parameters() if n.startswith(TEXT_PREFIXES)]
    assert text and all(p.requires_grad == (mode == "unfrozen_weights") for p in text)
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert all((id(p) in in_opt) == (mode == "unfrozen_weights") for p in text)
    assert port.text_projector.weight.requires_grad  # the fusion stage always trains
    imgs, meta, labels, cw = batch()
    make_train_step_weighted(augment=False, image_dtype=torch.float32)(
        state, torch.from_numpy(imgs), _tmeta(meta), torch.from_numpy(labels), 0,
        torch.from_numpy(cw))
    # the ViT block's backward runs where the image tower trains
    image_trains = mode in ("unfrozen_weights", "partial") and any(
        p.requires_grad for p in port.image_encoder.blocks.parameters())
    assert sum(calls.values()) == (BERT["num_layers"] * (mode == "unfrozen_weights")
                                   + image_trains)

    explicit = build_state(pair(RGATT, seed=41)[2],
                           TrainConfig(device="cpu", unfreeze_weights=mode,
                                       text_train_mode="unfrozen_weights"))
    assert all(p.requires_grad for n, p in explicit.model.named_parameters()
               if n.startswith("text_encoder"))
    onehot = MultimodalModel(**dict(CFG, text_model_name="one-hot-encoder",
                                    text_input_mode="features"), attention_mechanism=RGATT)
    build_state(onehot, TrainConfig(device="cpu", unfreeze_weights=mode))
    assert all(p.requires_grad for p in onehot.text_fc.parameters())


def test_state_dict_imports_into_skinjax(small_vit):
    """The other direction: the port's ``state_dict()`` through skinjax's
    ``import_multimodal_checkpoint`` (its sentence-checkpoint route,
    ``text_encoder.*`` → ``text_module/bert``) gives back the tree it came
    from, leaf for leaf."""
    _, params, port = pair(RGATT, seed=3)
    sd = {k: v.detach().numpy().copy() for k, v in port.state_dict().items()}
    assert any(k.startswith("text_encoder.encoder.layer.1.attention.self.query") for k in sd)
    back, _ = import_multimodal_checkpoint(sd, common_dim=CFG["common_dim"], backbone=TOWER)
    for name in params:
        flat = jax.tree_util.tree_leaves_with_path(params[name])
        other = dict(jax.tree_util.tree_leaves_with_path(back[name]))
        assert len(flat) == len(other), name
        for path, leaf in flat:
            np.testing.assert_array_equal(np.asarray(other[path]), leaf, err_msg=str(path))


def _sentence_dataset(tmp_path, n=24):
    csv_path, images = write_pad_ufes20_like(str(tmp_path / "data"), n=n, image_hw=(20, 24),
                                             sentences=True, paeth=False)
    tok_dir = tmp_path / "tokenizers"
    write_wordpiece_vocab(str(tok_dir / "bert-base-uncased" / "vocab.txt"),
                          row_sentences(pad_ufes20_table(n, seed=0)))
    return csv_path, images, str(tok_dir)


def test_schema_and_token_source_match_skinjax(tmp_path):
    """A PAD-UFES-20 CSV with a ``sentence`` column: the port's
    ``PreparedDataset`` keeps it in ``raw`` as strings and featurizes the
    table as skinjax does (in both, every column the schema does not drop is
    a feature, the sentence one-hot encoded with the rest; the tokens model
    does not read the features); ``build_token_source`` gives skinjax's token
    ids and masks at ``max_seq_length``."""
    csv_path, images, tok_dir = _sentence_dataset(tmp_path)
    ours, ref = prepare_dataset("pad-ufes-20", csv_path), jax_prepare_dataset("pad-ufes-20",
                                                                               csv_path)
    assert list(ours.raw["sentence"]) == list(ref.raw["sentence"].astype(str))
    assert all(isinstance(s, str) and s.startswith("A ") for s in ours.raw["sentence"])
    assert list(ours.featurizer.categorical_cols) == list(ref.featurizer.categorical_cols)
    np.testing.assert_array_equal(ours.features, ref.features)
    src = build_token_source(ours, images, "bert-base-uncased", max_seq_length=32,
                             tokenizers_dir=tok_dir)
    jsrc = jexp.build_token_source(ref, images, "bert-base-uncased", max_seq_length=32,
                                   tokenizers_dir=tok_dir)
    np.testing.assert_array_equal(src.input_ids, jsrc.input_ids)
    np.testing.assert_array_equal(src.attention_mask, jsrc.attention_mask)
    assert src.input_ids.shape == (24, 32) and (src.input_ids != 1).all()  # no [UNK]
    b = src.batch(np.arange(3))
    assert b["image"].shape == (3, 224, 224, 3) and set(b["metadata"]) == {"input_ids",
                                                                           "attention_mask"}
    with pytest.raises(ValueError, match="sentence"):
        build_token_source(_without_sentence(ours), images, "bert-base-uncased",
                           tokenizers_dir=tok_dir)


def _without_sentence(prepared):
    import dataclasses

    return dataclasses.replace(prepared, raw={k: v for k, v in prepared.raw.items()
                                              if k != "sentence"})


def _small_config(tmp_path, family):
    d = tmp_path / family
    d.mkdir(exist_ok=True)
    if family == "bert":
        c = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64, max_position_embeddings=48)
    else:
        c = dict(vocab_size=64, n_embd=32, n_layer=2, n_head=2, n_inner=64, n_positions=48)
    (d / "config.json").write_text(json.dumps(c))
    return d


@pytest.mark.parametrize("family", ["bert", "gpt2"])
def test_create_model_and_tower_weights(family, tmp_path):
    """``create_model`` with a BERT or GPT-2 name builds a tokens model (its
    tower from the directory's config.json, drawn at random, with skinjax's
    warning); with a ``pytorch_model.bin`` beside it (HF's layout: a
    ``bert.`` prefix, a pooler, older ``gamma``/``beta`` names; GPT-2's
    causal-mask buffers) ``build_sentence_tower`` loads it and
    ``create_model`` grafts it over the seed's draw."""
    name = "bert-base-uncased" if family == "bert" else "gpt2"
    d = _small_config(tmp_path, family)
    with pytest.warns(UserWarning, match="RANDOM init"):
        model = factory.create_model(num_classes=5, cnn_model_name="resnet-18", common_dim=32,
                                     text_model_name=name, attention_mechanism=RGATT,
                                     text_weights_dir=str(d), seed=1)
    assert model.text_input_mode == "tokens"
    assert model.text_pool == ("cls" if family == "bert" else "last")
    first = "text_encoder.embeddings.word_embeddings.weight" if family == "bert" \
        else "text_encoder.wte.weight"
    assert first in model.state_dict()
    _, meta, _, _ = batch()
    with torch.no_grad():
        out = model.eval()(torch.zeros(B, HW, HW, 3), _tmeta(meta))
    assert out.shape == (B, 5) and torch.isfinite(out).all()

    source = model.text_encoder.state_dict()
    raw = {}
    for k, v in source.items():
        if family == "bert":
            k = "bert." + (k[:-len("weight")] + "gamma" if "LayerNorm.weight" in k else
                           k[:-len("bias")] + "beta" if "LayerNorm.bias" in k else k)
        raw[k] = v + 1.0
    if family == "bert":
        raw["bert.pooler.dense.weight"] = torch.zeros(32, 32)
        raw["cls.predictions.bias"] = torch.zeros(64)
    else:
        raw["h.0.attn.bias"] = torch.ones(1, 1, 48, 48)
    torch.save(raw, d / "pytorch_model.bin")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tower = sentence.build_sentence_tower(name, str(d))
        model2 = factory.create_model(num_classes=5, cnn_model_name="resnet-18", common_dim=32,
                                      text_model_name=name, attention_mechanism=RGATT,
                                      text_weights_dir=str(d), seed=1)
    for k, v in source.items():
        assert torch.equal(tower.encoder.state_dict()[k], v + 1.0), k
        assert torch.equal(model2.text_encoder.state_dict()[k], v + 1.0), k
    with pytest.raises(NotImplementedError, match="native=False"):
        sentence.build_sentence_tower(name, native=False)


def test_build_sentence_tower_defaults_to_bert_base_at_random():
    """No local directory: skinjax's warning, and BERT-base's shape."""
    with pytest.warns(UserWarning, match="RANDOM init"):
        tower = sentence.build_sentence_tower("bert-base-uncased")
    enc = tower.encoder
    assert tower.pool == "cls" and tower.hidden_size == 768 and len(enc.encoder.layer) == 12
    assert enc.embeddings.word_embeddings.weight.shape == (30522, 768)
    assert tower.pretrained_state_dict is None


def test_env_config_reads_the_sentence_knobs(monkeypatch):
    from skinjax_torch.configs import load_env_config

    monkeypatch.setenv("TEXT_MODEL_NAME", "gpt2")
    monkeypatch.setenv("MAX_SEQ_LENGTH", "512")
    monkeypatch.setenv("TOKENIZERS_DIR", "/tmp/tok")
    cfg = load_env_config()
    assert (cfg.text_model_name, cfg.max_seq_length, cfg.tokenizers_dir) == ("gpt2", 512,
                                                                             "/tmp/tok")
    for k in ("TEXT_MODEL_NAME", "MAX_SEQ_LENGTH", "TOKENIZERS_DIR"):
        monkeypatch.delenv(k)
    cfg = load_env_config()
    assert (cfg.text_model_name, cfg.max_seq_length, cfg.tokenizers_dir) == (
        "one-hot-encoder", 256, None)


def test_train_cli_on_a_sentence_dataset(tmp_path, monkeypatch):
    """The train CLI in-process, ``TEXT_MODEL_NAME``/``MAX_SEQ_LENGTH``/
    ``TOKENIZERS_DIR`` from the environment, BERT made small (the default
    config monkeypatched), ResNet-18, RG-ATT, 2 folds × 1 epoch on the CPU:
    two fold results; the sentence recipe; the checkpoint reloads strictly
    into a new tokens model, which evaluates a batch of the token source."""
    from skinjax_torch.tools import train_cli
    from skinjax_torch.train import kfold

    csv_path, images, tok_dir = _sentence_dataset(tmp_path)
    small = {k: BERT[k] for k in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                                  "intermediate_size", "max_position_embeddings")}
    monkeypatch.setattr(sentence, "config_from_hf", lambda c: dict(small))
    for k, v in dict(TEXT_MODEL_NAME="bert-base-uncased", MAX_SEQ_LENGTH="24",
                     TOKENIZERS_DIR=tok_dir).items():
        monkeypatch.setenv(k, v)
    recipes = []
    run = kfold.run_kfold

    def spy(*a, **kw):
        recipes.append(kw["config"].augment_recipe)
        return run(*a, **kw)

    monkeypatch.setattr("skinjax_torch.train.experiments.run_kfold", spy)
    results = str(tmp_path / "results")
    with pytest.warns(UserWarning, match="RANDOM init"):
        metrics = train_cli.main([
            "--dataset", "pad-ufes-20", "--metadata-csv", csv_path, "--images-dir", images,
            "--results-dir", results, "--mechanisms", RGATT, "--backbones", "resnet-18",
            "--k-folds", "2", "--epochs", "1", "--batch-size", "8", "--device", "cpu"])
    assert len(metrics) == 2 and recipes == ["sentence"]
    assert all(np.isfinite(m["balanced_accuracy"]) for m in metrics)
    cell = os.path.join(results, f"multimodal_resnet-18_{RGATT}_h8")
    best = os.path.join(cell, f"multimodal_resnet-18_{RGATT}_h8_fold_1", "best", "state.pt")
    saved = torch.load(best, weights_only=True)["model"]
    assert any(k.startswith("text_encoder.encoder.layer.1.") for k in saved)

    prepared = prepare_dataset("pad-ufes-20", csv_path)
    with pytest.warns(UserWarning, match="RANDOM init"):
        model = factory.create_model(num_classes=6, cnn_model_name="resnet-18",
                                     text_model_name="bert-base-uncased",
                                     attention_mechanism=RGATT,
                                     vocab_size=prepared.feature_dim)
    model.load_state_dict(saved)
    src = build_token_source(prepared, images, "bert-base-uncased", max_seq_length=24,
                             tokenizers_dir=tok_dir)
    b = src.batch(np.arange(4))
    state = build_state(model, TrainConfig(device="cpu"))
    logits = make_eval_step(torch.float32)(state, torch.from_numpy(b["image"]),
                                           _tmeta(b["metadata"]))
    assert logits.shape == (4, 6) and torch.isfinite(logits).all()
