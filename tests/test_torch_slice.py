"""The port's serving slice against the JAX package: the flagship topology
(ResNet-50 + one-hot MLP + RG-ATT) at a small width, the same weights on both
sides (the JAX model's init tree, drawn from a seed → state_dict_from_flax →
the port), the same numpy inputs."""

import jax
import numpy as np
import pytest
import torch

from skinjax.models import MultimodalModel as JaxModel
from skinjax.serve.engine import InferenceEngine as JaxEngine
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.fusion.multimodal import _RGATT
from skinjax_torch.models.weights import init_weights, load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.ops import fusion_kernels as fk
from skinjax_torch.ops import global_attention as tga
from skinjax_torch.ops.attention import MultiheadAttention
from skinjax_torch.serve.engine import FUSED_MECHANISMS, InferenceEngine
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

CFG = dict(num_classes=4, num_heads=8, cnn_model_name="resnet-50", common_dim=32,
           vocab_size=7, attention_mechanism=_RGATT)
B, HW = 2, 32


@pytest.fixture(scope="module")
def slice_models():
    model = JaxModel(**CFG)
    variables = jax_variables(model, (HW, HW), CFG["vocab_size"], seed=1)
    port = MultimodalModel(**CFG)
    load_numpy_state_dict(port, state_dict_from_flax(variables["params"],
                                                     variables["batch_stats"]))
    return model, variables, port.eval()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(B, CFG["vocab_size"])).astype(np.float32)
    u8 = rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8)
    return img, meta, u8


def test_plain_logits_match_jax(slice_models):
    model, variables, port = slice_models
    img, meta, _ = _inputs(0)
    ref = np.asarray(jax.jit(model.apply)(variables, img, meta))
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    # tolerance of tests/test_full_model_parity.py: fp32 convs summed in
    # another order through 50 layers
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_fused_engine_matches_jax_fused_engine(slice_models, kind):
    model, variables, port = slice_models
    img, meta, u8 = _inputs(1)
    image = u8 if kind == "uint8" else img
    ref = JaxEngine(model, variables, use_fused=True).predict_probs(image, meta)
    fk.reset_launches()
    engine = InferenceEngine(port, use_fused=True, device="cpu")
    assert engine.fused
    out = engine.predict_probs(image, meta)
    assert sum(fk.LAUNCHES.values()) == 0  # CPU tensors take the plain twins
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("mech", [m for m in FUSED_MECHANISMS if m != _RGATT])
def test_fused_engine_matches_plain_engine(mech):
    model = MultimodalModel(num_classes=4, num_heads=4, cnn_model_name="resnet-18",
                            common_dim=32, vocab_size=7, attention_mechanism=mech)
    init_weights(model, seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():  # random biases and norm affines, so the gates and LNs matter
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    rng = np.random.default_rng(5)
    img = rng.normal(size=(3, HW, HW, 3)).astype(np.float32)
    meta = rng.normal(size=(3, 7)).astype(np.float32)
    plain = InferenceEngine(model, use_fused=False, device="cpu")
    fused = InferenceEngine(model, use_fused=True, device="cpu")
    assert fused.fused and not plain.fused
    np.testing.assert_allclose(fused.predict_probs(img, meta), plain.predict_probs(img, meta),
                               atol=1e-5)


def test_unported_parts_raise(monkeypatch):
    # the static-embedding tower is ported; tabular mode takes its TabTransformer
    model = MultimodalModel(num_classes=4, cnn_model_name="resnet-18",
                            text_model_name="static-embedding", vocab_size=12)
    assert model.text_tower.fc0.in_features == 12
    with pytest.raises(ValueError, match="TabTransformer"):
        MultimodalModel(num_classes=4, text_input_mode="tabular")
    with pytest.raises(ValueError, match="not implemented"):
        MultimodalModel(num_classes=4, attention_mechanism="no-such-mechanism")
    # every backbone of skinjax's registry is ported; a name outside it (skinjax
    # defines nextvit_base but registers no such tower) still raises
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        MultimodalModel(num_classes=4, cnn_model_name="nextvit_base")
    # the general attention path runs (K12); above the stored-P limit (lowered
    # to 0 here) its backward is K12's recompute backward, no longer a raise
    mha = MultiheadAttention(16, 4)
    assert mha(*[torch.zeros(2, 3, 16)] * 3).shape == (2, 3, 16)
    calls = []
    recompute = tga.global_attention_bwd_recompute
    monkeypatch.setattr(tga, "STORE_P_MAX_BYTES", 0)
    monkeypatch.setattr(tga, "global_attention_bwd_recompute",
                        lambda *a: calls.append(a) or recompute(*a))
    x = torch.randn(1, 40, 16, requires_grad=True)
    mha(x, x, x).sum().backward()
    assert len(calls) == 1 and x.grad.shape == x.shape


def test_measure_latency_refuses_the_cpu():
    model = MultimodalModel(num_classes=4, cnn_model_name="resnet-18", common_dim=16,
                            vocab_size=7)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model, device="cpu").measure_latency(n=1)
