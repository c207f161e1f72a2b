"""The port's fusion blocks against skinjax's (``skinjax/models/fusion/blocks.py``):
every block in eval mode on the same numpy-seeded weights, carried by
``block_state_dict``; the gradients at dropout 0 in train mode; attention
dropout's train-mode semantics (the fraction dropped, the 1/(1-p) scale, the
same seed giving the same bits, neither the seq-1 collapse nor K12 while it is
active); and the K12 shape gate (``ops/attention.py`` ``route``), which sends
shapes K12 does not take to the plain path. fp32 at atol/rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skinjax.models.fusion import blocks as jb
from skinjax.ops.attention import MultiHeadAttention as JaxMHA
from skinjax_torch.models.fusion import blocks as tb
from skinjax_torch.models.weights import block_state_dict, load_numpy_state_dict
from skinjax_torch.ops import attention as tattn
from skinjax_torch.ops import global_attention as tga
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(tree, seed):
    """Every leaf of a flax parameter tree drawn anew with numpy: kernels and
    embeddings at fan-in scale, scales near 1, the rest near 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ("kernel", "embedding"):
            fan_in = int(np.prod(x.shape[:-1])) if name == "kernel" else x.shape[-1]
            return (rng.normal(size=x.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "alpha"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (0.1 * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# kind: (skinjax module, port module, input shapes)
CASES = {
    "GatedAlteredResidualBlock": (lambda: jb.GatedAlteredResidualBlock(16, 4),
                                  lambda: tb.GatedAlteredResidualBlock(16, 4),
                                  [(2, 3, 16), (2, 5, 16), (2, 5, 16)]),
    "StackedGatedResidualBlock": (lambda: jb.StackedGatedResidualBlock(16, depth=2, num_heads=4),
                                  lambda: tb.StackedGatedResidualBlock(16, 2, 4),
                                  [(2, 3, 16)]),
    "ResidualBlock": (lambda: jb.ResidualBlock(16, num_heads=4),
                      lambda: tb.ResidualBlock(16, 4), [(2, 3, 16), (2, 5, 16), (2, 5, 16)]),
    "ResidualBlock-512-heads": (lambda: jb.ResidualBlock(16, num_heads=16),
                                lambda: tb.ResidualBlock(16, 16),
                                [(2, 1, 16), (2, 1, 16), (2, 1, 16)]),
    "AlteredResidualBlock": (lambda: jb.AlteredResidualBlock(16, 4),
                             lambda: tb.AlteredResidualBlock(16, 4),
                             [(2, 3, 16), (2, 3, 16), (2, 3, 16)]),
    "TransformerAttentionBlock": (lambda: jb.TransformerAttentionBlock(16, 4),
                                  lambda: tb.TransformerAttentionBlock(16, 4), [(2, 5, 16)]),
    "SimpleAttentionBlock": (lambda: jb.SimpleAttentionBlock(16, 4),
                             lambda: tb.SimpleAttentionBlock(16, 4), [(2, 5, 16)]),
    "MetaBlock": (lambda: jb.MetaBlock(12), lambda: tb.MetaBlock(6, 12),
                  [(2, 4, 4, 12), (2, 6)]),
    "MetaNet": (lambda: jb.MetaNet(8, 12), lambda: tb.MetaNet(6, 8, 12),
                [(2, 3, 3, 12), (2, 6)]),
    "MetaNet-pooled": (lambda: jb.MetaNet(8, 12), lambda: tb.MetaNet(6, 8, 12),
                       [(2, 12), (2, 6)]),
    "FeatureModulation": (lambda: jb.FeatureModulation(12), lambda: tb.FeatureModulation(6, 12),
                          [(2, 5, 12), (2, 6)]),
    "MLP": (lambda: jb.MLP((8, 6, 4), dropout_rate=0.2), lambda: tb.MLP(10, (8, 6, 4), 0.2),
            [(2, 10)]),
    "MLPHead": (lambda: jb.MLPHead(16, 3), lambda: tb.MLPHead(10, 16, 3), [(2, 10)]),
}


def _pair(case, seed=0):
    jax_ctor, port_ctor, shapes = CASES[case]
    kind = case.split("-")[0]
    jmod = jax_ctor()
    xs = inputs(shapes, seed)
    params = randomize(jmod.init(jax.random.key(0), *map(jnp.asarray, xs))["params"], seed + 1)
    port = port_ctor()
    load_numpy_state_dict(port, block_state_dict(kind, params))
    return jmod, params, port, xs


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_skinjax_in_eval_mode(case):
    jmod, params, port, xs = _pair(case)
    want = np.asarray(jmod.apply({"params": params}, *map(jnp.asarray, xs)))
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, xs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bilinear_pooling_matches_skinjax():
    from skinjax.models.fusion.sequence import BilinearPooling as JaxBilinear
    from skinjax_torch.models.fusion.sequence import BilinearPooling

    x, y = inputs([(3, 7), (3, 9)], 2)
    jmod = JaxBilinear(out_dim=5, rank=8)
    params = randomize(jmod.init(jax.random.key(0), x, y)["params"], 3)
    port = load_numpy_state_dict(BilinearPooling(7, 9, 5, 8),
                                 block_state_dict("BilinearPooling", params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply({"params": params}, x, y)), **TOL)


# at dropout 0, in train mode: the blocks whose dropout would act there
GRAD_CASES = {
    "TransformerAttentionBlock": (lambda: jb.TransformerAttentionBlock(16, 4, dropout_rate=0.0),
                                  lambda: tb.TransformerAttentionBlock(16, 4, 0.0), [(2, 5, 16)]),
    "AlteredResidualBlock": (lambda: jb.AlteredResidualBlock(16, 4, dropout_rate=0.0),
                             lambda: tb.AlteredResidualBlock(16, 4, 0.0),
                             [(2, 3, 16), (2, 3, 16), (2, 3, 16)]),
    "StackedGatedResidualBlock": (
        lambda: jb.StackedGatedResidualBlock(16, depth=2, num_heads=4, dropout_rate=0.0),
        lambda: tb.StackedGatedResidualBlock(16, 2, 4, 0.0), [(2, 3, 16)]),
    "SimpleAttentionBlock": (lambda: jb.SimpleAttentionBlock(16, 4, dropout_rate=0.0),
                             lambda: tb.SimpleAttentionBlock(16, 4, 0.0), [(2, 5, 16)]),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_block_gradients_match_skinjax_at_dropout_0(case):
    jax_ctor, port_ctor, shapes = GRAD_CASES[case]
    jmod, xs = jax_ctor(), inputs(shapes, 4)
    params = randomize(jmod.init(jax.random.key(0), *map(jnp.asarray, xs))["params"], 5)
    w = np.random.default_rng(6).normal(size=(2, *shapes[0][1:])).astype(np.float32)

    def loss(p, x0):
        out = jmod.apply({"params": p}, x0, *map(jnp.asarray, xs[1:]), deterministic=False)
        return (out * w).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(xs[0]))
    port = load_numpy_state_dict(port_ctor(), block_state_dict(case, params)).train()
    x0 = torch.from_numpy(xs[0]).requires_grad_(True)
    (port(x0, *map(torch.from_numpy, xs[1:])) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x0.grad.numpy(), np.asarray(gx), **TOL)
    want = block_state_dict(case, jax.tree_util.tree_map(np.asarray, gp))
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name].reshape(got[name].shape), **TOL,
                                   err_msg=name)


def _probe(p: float, S: int = 16):
    """An attention whose q/k projections are 0 (uniform softmax weights 1/S)
    and whose v and output projections are the identity, on keys that are the
    unit vectors: its output row i is row i of the (dropped) weights."""
    mha = tattn.MultiheadAttention(S, 1, dropout_rate=p)
    with torch.no_grad():
        mha.in_proj_weight.zero_()
        mha.in_proj_weight[2 * S:] = torch.eye(S)
        mha.in_proj_bias.zero_()
        mha.out_proj.weight.copy_(torch.eye(S))
        mha.out_proj.bias.zero_()
    return mha


def test_attention_dropout_drops_and_scales_the_weights(monkeypatch):
    S, p, B = 16, 0.25, 64
    mha = _probe(p, S)
    x = torch.eye(S).expand(B, S, S).contiguous()
    calls = []
    monkeypatch.setattr(tattn, "attention_core", lambda *a: calls.append(a) or tga.attention_core(*a))
    mha.train()
    assert mha.route(x, x) == "plain"
    torch.manual_seed(7)
    with torch.no_grad():
        a = mha(x, x, x)
    torch.manual_seed(7)
    with torch.no_grad():
        b = mha(x, x, x)
    assert not calls  # no K12 while attention dropout is active
    assert torch.equal(a, b)  # the same seed gives the same bits
    kept = 1 / S / (1 - p)
    vals = a.flatten()
    assert bool(((vals == 0) | ((vals - kept).abs() < 1e-6)).all())  # dropped or 1/(1-p)-scaled
    assert abs(float((vals == 0).float().mean()) - p) < 0.02  # 16384 weights: ~0.0034 std
    torch.manual_seed(8)
    with torch.no_grad():
        assert not torch.equal(mha(x, x, x), a)  # another seed, other masks
    mha.eval()  # inert in eval mode: the K12 route, uniform weights
    assert mha.route(x, x) == "k12"
    with torch.no_grad():
        out = mha(x, x, x)
    assert len(calls) == 1
    torch.testing.assert_close(out, torch.full_like(out, 1 / S), atol=1e-6, rtol=0)


def test_attention_dropout_disables_the_seq1_collapse():
    S, p, B = 16, 0.5, 256
    mha = _probe(p, S)
    v = torch.randn(B, 1, S)
    mha.train()
    assert mha.route(v, v) == "plain"
    torch.manual_seed(3)
    with torch.no_grad():
        out = mha(v, v, v)[:, 0]
    # the one weight is dropped (0) or kept at 1/(1-p): out is 0 or 2·v per row
    dropped = out.abs().sum(-1) == 0
    assert 0.35 < float(dropped.float().mean()) < 0.65
    torch.testing.assert_close(out[~dropped], 2 * v[~dropped, 0])
    mha.eval()
    assert mha.route(v, v) == "seq1"
    with torch.no_grad():
        torch.testing.assert_close(mha(v, v, v), v)
    # without attention dropout the collapse stays in train mode
    assert tattn.MultiheadAttention(S, 1).train().route(v, v) == "seq1"


@pytest.mark.parametrize("shape,want", [
    ((1, 1, 64, 8, False, False), "seq1"),
    ((20, 20, 32, 4, False, False), "k12"),  # TabTransformer: 8 channels a head
    ((4, 4, 512, 8, False, False), "k12"),  # sequence fusion's metadata tokens
    ((197, 197, 512, 8, False, False), "k12"),
    ((1024, 1024, 128, 2, False, False), "k12"),
    ((197, 197, 1024, 8, False, False), "plain"),  # 128 channels a head
    ((1025, 1025, 64, 1, False, False), "plain"),  # more than 1024 tokens
    ((197, 4, 512, 8, False, False), "plain"),  # cross-attention
    ((20, 20, 32, 4, True, False), "plain"),  # a mask
    ((20, 20, 32, 4, False, True), "plain"),  # attention dropout in train mode
    ((1, 1, 64, 8, False, True), "plain"),
])
def test_route_is_decided_from_the_shape(shape, want):
    assert tattn.route(*shape) == want


def test_shapes_k12_refuses_take_the_plain_path(monkeypatch):
    """128 channels a head: skinjax's XLA path, and the port's plain one;
    K12 is not called. On a shape K12 admits, its error still raises."""
    D, h = 256, 2
    q, kv = inputs([(2, 6, D), (2, 6, D)], 9)
    jmod = JaxMHA(D, h)
    params = randomize(jmod.init(jax.random.key(0), q, kv, kv)["params"], 10)
    port = load_numpy_state_dict(tattn.MultiheadAttention(D, h),
                                 block_state_dict("MultiHeadAttention", params)).eval()

    def refuse(*a):
        raise RuntimeError("K12 refused")

    monkeypatch.setattr(tattn, "attention_core", refuse)
    assert port.route(torch.from_numpy(q), torch.from_numpy(kv)) == "plain"
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (q, kv, kv))).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply({"params": params}, q, kv, kv)), **TOL)
    small = tattn.MultiheadAttention(32, 4).eval()  # 8 channels a head: K12's
    x = torch.randn(2, 20, 32)
    with pytest.raises(RuntimeError, match="K12 refused"):
        small(x, x, x)
