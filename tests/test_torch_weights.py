"""Weight conversion between the JAX package and the port:
state_dict_from_flax is the exact inverse of the JAX importer
(skinjax.models.torch_import.import_multimodal_checkpoint), and a port
state_dict feeds that importer as it is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skinjax.models import MultimodalModel as JaxModel
from skinjax.models.torch_import import filter_to_template, import_multimodal_checkpoint
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.weights import init_weights, load_numpy_state_dict, state_dict_from_flax
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

RGATT = "att-intramodal+residual+cross-attention-metadados"


_SHAPES = {}


def jax_variable_shapes(model, image_hw, vocab):
    """The variable tree's shapes and dtypes that flax would create:
    ``jax.eval_shape`` of ``model.init`` (it traces but compiles nothing),
    once per configuration (flax's repr prints every attribute; the test
    towers' registry names each stand for one tower)."""
    key = (repr(model), tuple(image_hw), vocab)
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(model.init, jax.random.key(0),
                                      jnp.zeros((1, *image_hw, 3)), jnp.zeros((1, vocab)))
    return _SHAPES[key]


def jax_variables(model, image_hw, vocab, seed):
    """Random variables of a JAX MultimodalModel, drawn with numpy on the
    parameter tree that flax would create (``jax_variable_shapes``). Every
    leaf is random: kernels at fan-in scale, biases and norm affines near 0
    and 1, BN running stats near (0, 1)."""
    shapes = jax_variable_shapes(model, image_hw, vocab)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _resnet18(mech):
    return dict(num_classes=3, num_heads=4, cnn_model_name="resnet-18", common_dim=16,
                vocab_size=5, attention_mechanism=mech)


CASES = {
    "rgatt-resnet50": dict(num_classes=4, cnn_model_name="resnet-50", common_dim=32,
                           vocab_size=7, attention_mechanism=RGATT),
    "weighted-resnet18": _resnet18("weighted"),
    # the subtrees only some mechanisms create (meta_block,
    # fc_after_metablock, fc_visual_only, fc_fusion_proj_feat2output) go
    # through the same round trip
    "metablock-resnet18": _resnet18("metablock"),
    "visual-only-resnet18": _resnet18("no-metadata-without-mlp"),
    "rg-att2fusefeatures-resnet18": _resnet18("rg-att2fusefeatures"),
}
# The reference model always holds both projectors, and the JAX importer
# reads them; flax creates none for mechanisms that stop before them.
_PROJECTORS = {f"{p}.{leaf}": np.zeros((1, 1) if leaf == "weight" else (1,), np.float32)
               for p in ("image_projector", "text_projector") for leaf in ("weight", "bias")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_round_trip_through_jax_importer_is_exact(case):
    cfg = CASES[case]
    mech = cfg["attention_mechanism"]
    variables = jax_variables(JaxModel(**cfg), (32, 32), cfg["vocab_size"], seed=0)
    params, stats = variables["params"], variables["batch_stats"]
    sd = state_dict_from_flax(params, stats)
    back_p, back_s = import_multimodal_checkpoint({**_PROJECTORS, **sd},
                                                  common_dim=cfg["common_dim"],
                                                  backbone=cfg["cnn_model_name"])
    back_p = filter_to_template(back_p, params)
    back_s = filter_to_template(back_s, stats)
    assert jax.tree_util.tree_structure(back_p) == jax.tree_util.tree_structure(params)
    assert jax.tree_util.tree_structure(back_s) == jax.tree_util.tree_structure(stats)
    for a, b in zip(jax.tree_util.tree_leaves(back_p) + jax.tree_util.tree_leaves(back_s),
                    jax.tree_util.tree_leaves(params) + jax.tree_util.tree_leaves(stats)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the converted keys are exactly the port model's own (strict load)
    load_numpy_state_dict(MultimodalModel(**cfg), sd)
    # flax creates no gate for RG-ATT and no attention for weighted
    assert ("img_gate.weight" in sd) == (mech == "weighted")
    assert ("image_residual.attn.in_proj_weight" in sd) == (mech in (RGATT, "rg-att2fusefeatures"))
    assert ("text_projector.weight" in sd) == (mech not in ("metablock", "no-metadata-without-mlp"))


def test_port_state_dict_feeds_the_jax_importer():
    cfg = CASES["weighted-resnet18"]
    port = init_weights(MultimodalModel(**cfg), seed=7).eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = import_multimodal_checkpoint(sd, common_dim=cfg["common_dim"],
                                                 backbone=cfg["cnn_model_name"])
    rng = np.random.default_rng(8)
    img = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    meta = rng.normal(size=(2, cfg["vocab_size"])).astype(np.float32)
    ref = np.asarray(jax.jit(JaxModel(**cfg).apply)({"params": params, "batch_stats": stats},
                                                     img, meta))
    with torch.no_grad():
        out = port(torch.from_numpy(img), torch.from_numpy(meta)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=5e-4)


def test_init_weights_is_seeded():
    cfg = CASES["weighted-resnet18"]
    a = init_weights(MultimodalModel(**cfg), seed=1).state_dict()
    b = init_weights(MultimodalModel(**cfg), seed=1).state_dict()
    c = init_weights(MultimodalModel(**cfg), seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["image_projector.weight"], c["image_projector.weight"])
