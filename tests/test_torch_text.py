"""The port's BERT and GPT-2 encoders (``skinjax_torch.models.text.bert`` /
``gpt2``) against skinjax's ``NativeBertEncoder`` / ``NativeGPT2Encoder`` at
a small size (2 layers, width 32, 2 heads, vocab 64, T ≤ 24), with the
parameters carried across by ``text_encoder_state_dict``: the last hidden
state in fp32 eval with and without a padding mask, the pooled tower, the
gradient of a scalar loss w.r.t. every parameter, GPT-2's causality,
train-mode attention dropout from one shared (T, T) draw, and the other
direction (the port's ``state_dict`` through skinjax's importers, and into
``transformers``' models where that package imports)."""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skinjax.models.text.bert import NativeBertEncoder as JBert
from skinjax.models.text.bert import NativeSentenceTower as JTower
from skinjax.models.text.gpt2 import NativeGPT2Encoder as JGPT2
from skinjax.models.torch_import import import_torch_bert, import_torch_gpt2
from skinjax_torch.models.text import bert as tbert
from skinjax_torch.models.text import gpt2 as tgpt2
from skinjax_torch.models.weights import load_numpy_state_dict, text_encoder_state_dict
from skinjax_torch.ops import global_attention as tga
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
             max_position_embeddings=48)
FAMILIES = ("bert", "gpt2")
NO_DROPOUT = {"bert": dict(hidden_dropout=0.0, attention_dropout=0.0),
              "gpt2": dict(embd_dropout=0.0, resid_dropout=0.0, attention_dropout=0.0)}
B, T = 3, 24


@functools.lru_cache(maxsize=None)
def _jitted(family, kind, **kw):
    """skinjax's encoder's jitted ``init`` or ``apply`` (``kind``), one a
    (family, knobs): each compiles once a call signature and is shared by
    the tests, where eager dispatch compiled every primitive again."""
    jmod = (JBert if family == "bert" else JGPT2)(**dict(SMALL, **kw))
    return jax.jit(getattr(jmod, kind), static_argnames=("deterministic",))


@functools.lru_cache(maxsize=None)
def _jax_params(family, seed):
    """skinjax's init plus noise for ``_pair``, drawn once a (family, seed)
    (the dropout knobs change no parameter)."""
    params = _jitted(family, "init")(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(np.float32), params)


def _pair(family, seed=0, **kw):
    """skinjax's encoder with random parameters (its init plus noise, so
    that biases and norms are not trivial), and the port's holding them."""
    kw = dict(SMALL, **kw)
    jmod = (JBert if family == "bert" else JGPT2)(**kw)
    params = _jax_params(family, seed)
    port = (tbert.NativeBertEncoder if family == "bert" else tgpt2.NativeGPT2Encoder)(**kw)
    load_numpy_state_dict(port, text_encoder_state_dict({family: params}))
    return jmod, params, port


def _tokens(seed=1, masked=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SMALL["vocab_size"], (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    if masked:  # right padding, as the tokenizers pad
        mask[0, 17:] = 0
        mask[2, 5:] = 0
    return ids, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_hidden_state_matches_skinjax(family, masked):
    """The last hidden state in fp32 eval, with and without padding (1e-5)."""
    _, params, port = _pair(family)
    ids, mask = _tokens(masked=masked)
    jm = jnp.asarray(mask) if masked else None
    ref = _jitted(family, "apply")({"params": params}, jnp.asarray(ids), jm)
    tga.reset_launches()
    with torch.no_grad():
        out = port.eval()(torch.tensor(ids), torch.tensor(mask) if masked else None)
    assert sum(tga.LAUNCHES.values()) == 0  # CPU tensors take the twins
    assert out.shape == (B, T, SMALL["hidden_size"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_pooled_tower_matches_skinjax(family):
    """``NativeSentenceTower``: BERT pools [:, 0], GPT-2 [:, -1] (padding
    included); skinjax's tower scopes the encoder as 'bert' / 'gpt2'."""
    jmod, params, port = _pair(family)
    pool = "cls" if family == "bert" else "last"
    ids, mask = _tokens()
    ref = JTower(encoder=jmod, pool=pool, scope_name=family).apply(
        {"params": {family: params}}, jnp.asarray(ids), jnp.asarray(mask))
    tower = tbert.NativeSentenceTower(port, pool=pool).eval()
    with torch.no_grad():
        out = tower(torch.tensor(ids), torch.tensor(mask))
    assert out.shape == (B, SMALL["hidden_size"]) and tower.hidden_size == SMALL["hidden_size"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_skinjax(family):
    """d(Σ hidden·W)/d(every parameter), dropout off, fp32: each tensor
    within 1e-4 of its norm plus 1e-6 of the norm of all the gradients (the
    key bias's gradient is 0 by the math, a constant added to every score of
    a row leaving the softmax as it is, so only rounding noise reaches it)."""
    jmod, params, port = _pair(family, **NO_DROPOUT[family])
    ids, mask = _tokens()
    w = np.random.default_rng(2).normal(size=(B, T, SMALL["hidden_size"])).astype(np.float32)

    def loss(p):
        return jnp.sum(jmod.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                                  deterministic=False) * w)

    ref = text_encoder_state_dict({family: jax.jit(jax.grad(loss))(params)})
    port.train()
    (port(torch.tensor(ids), torch.tensor(mask)) * torch.tensor(w)).sum().backward()
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(ref)
    g_all = float(np.sqrt(sum(np.square(np.asarray(r, np.float64)).sum() for r in ref.values())))
    for k, g in got.items():
        r = np.asarray(ref[k])
        err = float(np.linalg.norm(g.numpy() - r))
        assert err <= 1e-4 * float(np.linalg.norm(r)) + 1e-6 * g_all, (k, err)


def test_gpt2_is_causal():
    """Changing a later token leaves every earlier position as it was."""
    _, _, port = _pair("gpt2")
    ids, _ = _tokens()
    ids2 = ids.copy()
    ids2[:, 10] = (ids2[:, 10] + 1) % SMALL["vocab_size"]
    port.eval()
    with torch.no_grad():
        a, b = port(torch.tensor(ids)), port(torch.tensor(ids2))
    assert torch.equal(a[:, :10], b[:, :10])
    assert not torch.allclose(a[:, 10:], b[:, 10:])


@pytest.mark.parametrize("family", FAMILIES)
def test_attention_dropout_is_one_shared_draw(family, monkeypatch):
    """Train mode, attention dropout 0.2 (the other dropouts off): each
    layer's (T, T) keep draw, made once with numpy and handed to both sides
    (skinjax's through ``jax.random.bernoulli``, the port's through
    ``attention_dropout_pmult``), gives the same output (1e-5), and the port
    hands K12 keep / 0.8 as its pmult."""
    rate = 0.2
    kw = dict(NO_DROPOUT[family], attention_dropout=rate)
    jmod, params, port = _pair(family, **kw)
    ids, mask = _tokens()
    rng = np.random.default_rng(3)
    keeps = [rng.uniform(size=(T, T)) < 1 - rate for _ in range(SMALL["num_layers"])]

    j_draws, t_draws, pmults = iter(keeps), iter(keeps), []

    def bernoulli(key, p, shape):
        assert shape == (1, 1, T, T) and abs(p - (1 - rate)) < 1e-12
        return jnp.asarray(next(j_draws))[None, None]

    def draw(n, r, device, generator=None):
        assert (n, r) == (T, rate)
        pmults.append(torch.tensor(next(t_draws)).float() / (1 - rate))
        return pmults[-1]

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(tbert, "attention_dropout_pmult", draw)
    monkeypatch.setattr(tgpt2, "attention_dropout_pmult", draw)
    ref = jmod.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                     deterministic=False, rngs={"dropout": jax.random.key(0)})
    with torch.no_grad():
        out = port.train()(torch.tensor(ids), torch.tensor(mask))
    assert len(pmults) == SMALL["num_layers"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_attention_dropout_pmult_draw():
    """The port's own draw: (T, T) of 0 and 1/(1 − p), about 1 − p kept,
    the same from the same generator seed."""
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a = tbert.attention_dropout_pmult(64, 0.1, "cpu", g())
    assert a.shape == (64, 64) and a.dtype == torch.float32
    assert torch.equal(torch.unique(a), torch.tensor([0.0, 1 / 0.9]))
    assert 0.85 < float((a > 0).float().mean()) < 0.95
    assert torch.equal(a, tbert.attention_dropout_pmult(64, 0.1, "cpu", g()))


@pytest.mark.parametrize("family", FAMILIES)
def test_state_dict_imports_into_skinjax_and_transformers(family):
    """The other direction: the port's ``state_dict()`` through skinjax's
    ``import_torch_bert`` / ``import_torch_gpt2`` gives skinjax the same
    outputs; where ``transformers`` imports, its ``BertModel`` (no pooler) /
    ``GPT2Model`` built from the same small config loads it with
    strict=True and agrees (1e-5)."""
    jmod, _, port = _pair(family, seed=4)
    ids, mask = _tokens(seed=5)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params = (import_torch_bert if family == "bert" else import_torch_gpt2)(sd)
    ref = _jitted(family, "apply")({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    port.eval()
    with torch.no_grad():
        out = port(torch.tensor(ids), torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)

    transformers = pytest.importorskip("transformers")
    if family == "bert":
        cfg = transformers.BertConfig(
            vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=48, layer_norm_eps=1e-12)
        hf = transformers.BertModel(cfg, add_pooling_layer=False)
    else:
        cfg = transformers.GPT2Config(vocab_size=64, n_embd=32, n_layer=2, n_head=2, n_inner=64,
                                      n_positions=48)
        hf = transformers.GPT2Model(cfg)
    hf.load_state_dict(port.state_dict(), strict=True)
    hf.eval()
    with torch.no_grad():
        hf_out = hf(input_ids=torch.tensor(ids).long(),
                    attention_mask=torch.tensor(mask).long()).last_hidden_state
    # HF masks with finfo.min, skinjax and the port with -1e9: both weigh a
    # padded key exactly 0. GPT-2's padded positions attend causally in
    # every implementation, so the comparison covers every position.
    np.testing.assert_allclose(out.numpy(), hf_out.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_config_from_hf_dict_and_file(family, tmp_path):
    """``config_from_hf`` / ``config_from_hf_gpt2`` read a HF config as a
    dict, a config.json path or its directory, with HF's defaults, the
    same kwargs skinjax's take from a transformers config object."""
    import json

    if family == "bert":
        c = {"vocab_size": 99, "hidden_size": 48, "num_hidden_layers": 3,
             "num_attention_heads": 4, "intermediate_size": 96}
        fn, want = tbert.config_from_hf, dict(
            vocab_size=99, hidden_size=48, num_layers=3, num_heads=4, intermediate_size=96,
            max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
            hidden_dropout=0.1, attention_dropout=0.1)
    else:
        c = {"vocab_size": 99, "n_embd": 48, "n_layer": 3, "n_head": 4, "n_inner": None}
        fn, want = tgpt2.config_from_hf_gpt2, dict(
            vocab_size=99, hidden_size=48, num_layers=3, num_heads=4, intermediate_size=192,
            max_position_embeddings=1024, layer_norm_eps=1e-5, embd_dropout=0.1,
            resid_dropout=0.1, attention_dropout=0.1)
    (tmp_path / "config.json").write_text(json.dumps(c))
    assert fn(c) == fn(tmp_path / "config.json") == fn(tmp_path) == want
    assert fn({}) == fn({}) and fn({})["hidden_size"] == 768
