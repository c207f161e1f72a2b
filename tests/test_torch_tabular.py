"""The tabular and static-embedding metadata paths against skinjax's:
``index_encode``/``cardinalities``/``TabularSource`` on a PAD-UFES-20-shaped
CSV; TabTransformer and the static-embedding tower, alone and inside the
multimodal model (RG-ATT), in eval mode and, at dropout 0, their gradients;
``load_model2vec`` through both artifact routes and the numpy safetensors
reader against ``safetensors.numpy``; the tabular model through the fold
loop; the freeze policy's trainable sets for both towers. fp32 at atol/rtol
1e-4."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from skinjax.data import schemas as jschemas
from skinjax.data import tabular as jtab
from skinjax.data.featurizer import MetadataFeaturizer as JaxFeaturizer
from skinjax.models import MultimodalModel as JaxModel
from skinjax.models.text import StaticEmbeddingTower as JaxStatic
from skinjax.models.text import TabTransformer as JaxTab
from skinjax.models.text import static_embed as jstatic
from skinjax.train.optimizer import trainable_mask as jax_trainable_mask
from skinjax_torch.data import schemas, tabular
from skinjax_torch.data.featurizer import MetadataFeaturizer
from skinjax_torch.data.fixtures import write_model2vec, write_pad_ufes20_like
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.factory import create_model
from skinjax_torch.models.text import StaticEmbeddingTower, TabTransformer
from skinjax_torch.models.text import static_embed
from skinjax_torch.models.weights import (
    block_state_dict,
    init_weights,
    load_numpy_state_dict,
    state_dict_from_flax,
)
from skinjax_torch.train.kfold import SubsetSource
from skinjax_torch.train.loop import TrainConfig, build_state, train_process
from skinjax_torch.train.optimizer import FREEZE_MODES
from tests.test_torch_blocks import randomize
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
RGATT = "att-intramodal+residual+cross-attention-metadados"
CARDS, N_NUM = (3, 4, 5), 2
TAB = dict(embed_dim=8, num_heads=2, num_layers=2, hidden_dim=16, out_dim=24)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tab_inputs(B, seed):
    rng = np.random.default_rng(seed)
    cats = np.stack([rng.integers(0, c, B) for c in CARDS], axis=1).astype(np.int32)
    return cats, rng.normal(size=(B, N_NUM)).astype(np.float32)


@pytest.fixture(scope="module")
def pad20(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pad20"))
    csv_path, images_dir = write_pad_ufes20_like(root, n=24, image_hw=(16, 16))
    return csv_path, images_dir


def test_index_encoding_matches_skinjax(tmp_path):
    fz = JaxFeaturizer(categorical_cols=["region", "itch"], numerical_cols=["age"])
    fz.ohe.categories = [["ARM", "FACE"], ["False", "True"]]
    fz.scaler.mean, fz.scaler.scale = np.array([50.0]), np.array([10.0])
    fz.label_encoder.classes = ["A", "B"]
    path = str(tmp_path / "fz.json")
    fz.save(path)
    table = {"region": np.array(["FACE", "ARM", "MARS"], dtype=object),
             "itch": np.array(["True", "False", "True"], dtype=object),
             "age": np.array([60.0, 40.0, 50.0])}
    port_fz = MetadataFeaturizer.load(path)
    for want, got in zip(jtab.index_encode(fz, table), tabular.index_encode(port_fz, table)):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got, want)
    assert tabular.cardinalities(port_fz) == jtab.cardinalities(fz) == (3, 3)
    port_fz.scale_numerics = False  # unscaled numerics pass through as float32
    fz.scale_numerics = False
    np.testing.assert_array_equal(tabular.index_encode(port_fz, table)[1],
                                  jtab.index_encode(fz, table)[1])


def test_tabular_source_matches_skinjax(pad20):
    """skinjax's ``from_prepared`` hands the cleaned numeric cells (``EMPTY``
    where missing) to ``index_encode``, which cannot convert them; the port
    coerces them as the featurizer's inputs are (-1). skinjax's source is
    built here from skinjax's ``index_encode`` of the coerced columns."""
    csv_path, _ = pad20
    jprep = jschemas.prepare_dataset("pad-ufes-20", csv_path)
    prep = schemas.prepare_dataset("pad-ufes-20", csv_path)
    images = np.random.default_rng(0).integers(0, 256, (len(prep.labels), 8, 8, 3), np.uint8)
    jfz = jprep.featurizer
    assert any("EMPTY" in set(jprep.raw[c].astype(str))  # the fixture has missing numerics
               for c in jfz.numerical_cols)
    with pytest.raises(ValueError):
        jtab.TabularSource.from_prepared(jprep, images)
    table = {c: jprep.raw[c].to_numpy() for c in jfz.categorical_cols}
    table.update({c: pd.to_numeric(jprep.raw[c], errors="coerce").fillna(-1).to_numpy()
                  for c in jfz.numerical_cols})
    want = jtab.TabularSource(images, None, *jtab.index_encode(jfz, table), jprep.labels)
    got = tabular.TabularSource.from_prepared(prep, images)
    # the numerics are the scaled numerics of the one-hot features
    np.testing.assert_allclose(got.numerical, prep.features[:, -len(jfz.numerical_cols):])
    np.testing.assert_array_equal(got.categorical, want.categorical)
    np.testing.assert_allclose(got.numerical, want.numerical, rtol=1e-6)
    np.testing.assert_array_equal(got.labels, want.labels)
    idx = np.array([5, 0, 17])
    a, b = got.batch(idx), want.batch(idx)
    assert set(a["metadata"]) == set(b["metadata"]) == {"categorical", "numerical"}
    for k in ("categorical", "numerical"):
        assert a["metadata"][k].dtype == b["metadata"][k].dtype
        np.testing.assert_allclose(a["metadata"][k], b["metadata"][k], rtol=1e-6)
    np.testing.assert_array_equal(a["image"], b["image"])
    assert tabular.cardinalities(prep.featurizer) == jtab.cardinalities(jprep.featurizer)


def _tab_pair(dropout, seed=0):
    cats, nums = _tab_inputs(2, seed)
    jmod = JaxTab(CARDS, N_NUM, dropout_rate=dropout, **TAB)
    params = randomize(jmod.init(jax.random.key(0), cats, nums)["params"], seed + 1)
    port = TabTransformer(CARDS, N_NUM, dropout_rate=dropout, **TAB)
    load_numpy_state_dict(port, block_state_dict("TabTransformer", params))
    return jmod, params, port, cats, nums


def test_tab_transformer_matches_skinjax():
    jmod, params, port, _, _ = _tab_pair(0.3)
    cats, nums = _tab_inputs(5, 7)
    want = np.asarray(jmod.apply({"params": params}, cats, nums))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(cats).long(), torch.from_numpy(nums)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_tab_transformer_gradients_match_skinjax_at_dropout_0():
    jmod, params, port, cats, nums = _tab_pair(0.0, seed=3)
    w = np.random.default_rng(4).normal(size=(2, TAB["out_dim"])).astype(np.float32)

    def loss(p, x):
        return (jmod.apply({"params": p}, cats, x, deterministic=False) * w).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(nums))
    x = torch.from_numpy(nums).requires_grad_(True)
    (port.train()(torch.from_numpy(cats), x) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **TOL)
    want = block_state_dict("TabTransformer", jax.tree_util.tree_map(np.asarray, gp))
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **TOL, err_msg=name)


def _jax_tab_model():
    tower = JaxTab(CARDS, N_NUM, **TAB)
    return JaxModel(num_classes=3, num_heads=4, cnn_model_name="custom-cnn", common_dim=32,
                    text_encoder_dim_output=TAB["out_dim"], text_module=tower,
                    text_input_mode="tabular", attention_mechanism=RGATT)


def _port_tab_model():
    return MultimodalModel(num_classes=3, num_heads=4, cnn_model_name="custom-cnn",
                           common_dim=32, text_module=TabTransformer(CARDS, N_NUM, **TAB),
                           text_input_mode="tabular", attention_mechanism=RGATT)


def _jax_tab_shapes(model):
    """The parameter tree's shapes, in flax's creation order."""
    cats, nums = _tab_inputs(1, 0)
    return jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                          {"categorical": cats, "numerical": nums})["params"]


def _jax_tab_variables(model, seed):
    return randomize(_jax_tab_shapes(model), seed)


def test_tabular_model_matches_skinjax():
    jmodel = _jax_tab_model()
    params = _jax_tab_variables(jmodel, 11)
    port = load_numpy_state_dict(_port_tab_model(), state_dict_from_flax(params, {})).eval()
    rng = np.random.default_rng(12)
    img = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    cats, nums = _tab_inputs(3, 13)
    want = np.asarray(jmodel.apply({"params": params}, img,
                                   {"categorical": cats, "numerical": nums}))
    with torch.no_grad():
        got = port(torch.from_numpy(img), {"categorical": torch.from_numpy(cats),
                                           "numerical": torch.from_numpy(nums)}).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_static_embedding_model_matches_skinjax():
    cfg = dict(num_classes=3, num_heads=4, cnn_model_name="custom-cnn", common_dim=32,
               text_encoder_dim_output=32, vocab_size=24, attention_mechanism=RGATT,
               text_model_name="static-embedding")
    jmodel = JaxModel(**cfg)
    variables = jax_variables(jmodel, (16, 16), 24, seed=14)
    port = load_numpy_state_dict(MultimodalModel(**cfg),
                                 state_dict_from_flax(variables["params"], {})).eval()
    assert isinstance(port.text_tower, StaticEmbeddingTower)
    rng = np.random.default_rng(15)
    img = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    emb = rng.normal(size=(3, 24)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(variables, img, emb)), **TOL)
    # the factory builds it with the metadata width as the tower's input
    built = create_model(num_classes=3, cnn_model_name="custom-cnn", common_dim=32,
                         vocab_size=24, text_model_name="static-embedding")
    assert built.text_tower.fc0.in_features == 24


def test_static_embedding_tower_matches_skinjax():
    x = np.random.default_rng(16).normal(size=(4, 10)).astype(np.float32)
    jmod = JaxStatic(out_dim=6, hidden=12)
    params = randomize(jmod.init(jax.random.key(0), x)["params"], 17)
    port = load_numpy_state_dict(StaticEmbeddingTower(10, 6, 12),
                                 block_state_dict("StaticEmbeddingTower", params))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply({"params": params}, x)), **TOL)


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "skin", "lesion", "##s", "arm", "red", "the"]
TEXTS = ["skin lesion", "red arm skin", "lesions", "", "the unknownword arm"]


def _artifact(d, tokenizer_json, normalize=True):
    from safetensors.numpy import save_file

    emb = np.random.default_rng(0).normal(size=(len(VOCAB), 8)).astype(np.float32)
    save_file({"embeddings": emb}, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"normalize": normalize}, f)
    if tokenizer_json:
        from tokenizers import Tokenizer
        from tokenizers.models import WordPiece
        from tokenizers.normalizers import Lowercase
        from tokenizers.pre_tokenizers import Whitespace

        tok = Tokenizer(WordPiece({t: i for i, t in enumerate(VOCAB)}, unk_token="[UNK]"))
        tok.normalizer = Lowercase()
        tok.pre_tokenizer = Whitespace()
        tok.save(os.path.join(d, "tokenizer.json"))
    else:
        with open(os.path.join(d, "vocab.txt"), "w") as f:
            f.write("\n".join(VOCAB))
    return emb


@pytest.mark.parametrize("route", ["tokenizer.json", "vocab.txt"])
@pytest.mark.parametrize("normalize", [True, False])
def test_load_model2vec_matches_skinjax(tmp_path, route, normalize):
    _artifact(str(tmp_path), route == "tokenizer.json", normalize)
    got = static_embed.load_model2vec(str(tmp_path))
    want = jstatic.load_model2vec(str(tmp_path))
    assert got.normalize == want.normalize == normalize
    np.testing.assert_array_equal(got.embeddings, want.embeddings)
    np.testing.assert_allclose(got.encode(TEXTS), want.encode(TEXTS), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(static_embed.encode_sentences(TEXTS, str(tmp_path)),
                               want.encode(TEXTS), rtol=1e-6, atol=1e-7)


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(1)
    tensors = {"a": rng.normal(size=(3, 5)).astype(np.float32),
               "b": rng.normal(size=(7,)).astype(np.float16),
               "c": rng.integers(-9, 9, (2, 2, 2)).astype(np.int64),
               "d": rng.integers(0, 255, (4,)).astype(np.uint8),
               "e": rng.normal(size=(2, 3)).astype(np.float64),
               "f": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "np"})
    got, want = static_embed.read_safetensors(path), load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    # bf16 widens to float32: bf16 is the top half of a float32's bits
    x = rng.normal(size=(6,)).astype(np.float32)
    bits = (x.view(np.uint32) >> 16).astype("<u2")
    header = json.dumps({"x": {"dtype": "BF16", "shape": [6], "data_offsets": [0, 12]}}).encode()
    with open(tmp_path / "bf16.safetensors", "wb") as f:
        f.write(len(header).to_bytes(8, "little") + header + bits.tobytes())
    got = static_embed.read_safetensors(str(tmp_path / "bf16.safetensors"))["x"]
    np.testing.assert_array_equal(got, (bits.astype(np.uint32) << 16).view(np.float32))


def test_written_artifact_reads_back_through_skinjax(tmp_path):
    from safetensors.numpy import load_file

    emb = np.random.default_rng(2).normal(size=(len(VOCAB), 6)).astype(np.float32)
    write_model2vec(str(tmp_path), emb, VOCAB, normalize=True)
    np.testing.assert_array_equal(load_file(str(tmp_path / "model.safetensors"))["embeddings"],
                                  emb)
    np.testing.assert_allclose(static_embed.load_model2vec(str(tmp_path)).encode(TEXTS),
                               jstatic.load_model2vec(str(tmp_path)).encode(TEXTS), rtol=1e-6)


def test_tokenizer_json_without_tokenizers_names_the_vocab_route(tmp_path, monkeypatch):
    import builtins

    _artifact(str(tmp_path), tokenizer_json=True)
    real_import = builtins.__import__

    def no_tokenizers(name, *a, **kw):
        if name.split(".")[0] == "tokenizers":
            raise ImportError("no tokenizers")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.raises(ImportError, match="vocab.txt"):
        static_embed.load_model2vec(str(tmp_path))


def test_tabular_model_trains_through_the_fold_loop(pad20):
    csv_path, _ = pad20
    prep = schemas.prepare_dataset("pad-ufes-20", csv_path)
    n = len(prep.labels)
    images = np.random.default_rng(3).integers(0, 256, (n, 16, 16, 3), np.uint8)
    src = tabular.TabularSource.from_prepared(prep, images)
    tower = TabTransformer(tabular.cardinalities(prep.featurizer),
                           len(prep.featurizer.numerical_cols), **TAB)
    model = init_weights(MultimodalModel(
        num_classes=prep.num_classes, num_heads=4, cnn_model_name="custom-cnn", common_dim=32,
        text_module=tower, text_input_mode="tabular", attention_mechanism=RGATT), seed=0)
    seen = []
    forward = model.forward
    model.forward = lambda image, metadata: seen.append(metadata) or forward(image, metadata)
    state, metrics, history = train_process(
        model, SubsetSource(src, np.arange(16)), SubsetSource(src, np.arange(16, n)),
        prep.num_classes,
        config=TrainConfig(num_epochs=2, batch_size=8, image_dtype="float32", augment=False,
                           device="cpu", learning_rate=1e-3))
    assert np.isfinite(history["train_loss"]).all() and len(history["train_loss"]) == 2
    assert np.isfinite(metrics["balanced_accuracy"])
    assert all(not m["categorical"].is_floating_point() and m["numerical"].dtype == torch.float32
               for m in seen)


def _trainable_scalars_jax(model, init_args, mode):
    """skinjax's trainable scalars under a text freeze mode, with its masks
    taken inside one ``eval_shape`` of ``init``, on the tree in creation
    order (the "last layer" is the last created; eval_shape's output tree
    comes back sorted)."""
    count = {}

    def run():
        params = model.init(jax.random.key(0), *init_args)["params"]
        mask = jax_trainable_mask(params, "unfrozen_weights")
        if mode != "unfrozen_weights":
            text = jax_trainable_mask(params, mode, frozen_prefixes=("text_tower", "text_module"))
            mask = jax.tree_util.tree_map(lambda a, b: a and b, mask, text)
        sizes = jax.tree_util.tree_map(lambda x, m: int(np.prod(x.shape)) * m, params, mask)
        count["n"] = sum(jax.tree_util.tree_leaves(sizes))
        return 0

    jax.eval_shape(run)
    return count["n"]


@pytest.mark.parametrize("mode", FREEZE_MODES)
@pytest.mark.parametrize("tower", ["tabular", "static-embedding"])
def test_text_freeze_sets_match_skinjax(mode, tower):
    img = jnp.zeros((1, 16, 16, 3))
    if tower == "tabular":
        jmodel, port = _jax_tab_model(), _port_tab_model()
        cats, nums = _tab_inputs(1, 0)
        init_args = (img, {"categorical": cats, "numerical": nums})
    else:
        cfg = dict(num_classes=3, num_heads=4, cnn_model_name="custom-cnn", common_dim=32,
                   text_encoder_dim_output=32, vocab_size=24, attention_mechanism=RGATT,
                   text_model_name="static-embedding")
        jmodel, port = JaxModel(**cfg), MultimodalModel(**cfg)
        init_args = (img, jnp.zeros((1, 24)))
    state = build_state(port, TrainConfig(device="cpu", text_train_mode=mode))
    got = sum(p.numel() for p in state.model.parameters() if p.requires_grad)
    assert got == _trainable_scalars_jax(jmodel, init_args, mode)
    # the default (no text mode) leaves both towers trainable, as in skinjax
    default = build_state(port, TrainConfig(device="cpu", unfreeze_weights="frozen_weights"))
    prefix = "text_module" if tower == "tabular" else "text_tower"
    assert all(p.requires_grad for n, p in default.model.named_parameters()
               if n.startswith(prefix))
