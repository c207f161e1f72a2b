"""The port's fusion kernels (skinjax_torch.ops.fusion_kernels) against the
JAX package's Pallas kernels (interpret mode on the CPU), on the same numpy
arrays. On the CPU the port's wrappers run their plain PyTorch twins; the
CUDA kernels are held against the same twins on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skinjax.ops.pallas import fusion_kernels as jfk
from skinjax_torch.ops import fusion_kernels as tfk
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

B, D = 5, 64
HEAD = (2 * D, D, D // 2, 6)  # x width, fc1, fc2 (hidden // 2), classes

# f32 activations: both sides accumulate in fp32, as test_pallas_kernels.py
F32_TOL = dict(atol=1e-5, rtol=0)
# bf16 activations with f32 weights: the two frameworks sum in another order
# around the points where values round to bf16, and one bf16 ulp near 1 is
# 2**-8 ≈ 4e-3, so the outputs may differ by a few ulps of bf16
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        scale = 1.0 / np.sqrt(s[0]) if len(s) == 2 else 0.5
        out.append((rng.normal(size=s) * scale).astype(np.float32))
    return out


def _acts(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _ln_params(seed, n):
    rng = np.random.default_rng(seed)
    return [(1 + 0.1 * rng.normal(size=n)).astype(np.float32),
            (0.1 * rng.normal(size=n)).astype(np.float32)]


def _seq1_args(seed):
    wv, bv, wo, bo = _arrays(seed, (D, D), (D,), (D, D), (D,))
    return [wv, bv, wo, bo]


def _grb_args(seed):
    wv, bv, wo, bo, wg, bg = _arrays(seed, (D, D), (D,), (D, D), (D,), (D, D), (D,))
    return [wv, bv, wo, bo, wg, bg, *_ln_params(seed + 1, D)]


def _head_args(seed):
    k1, n1, n2, n3 = HEAD
    w1, b1 = _arrays(seed, (k1, n1), (n1,))
    w2, b2 = _arrays(seed + 1, (n1, n2), (n2,))
    w3, b3 = _arrays(seed + 2, (n2, n3), (n3,))
    return [w1, b1, *_ln_params(seed + 3, n1), w2, b2, *_ln_params(seed + 4, n2), w3, b3]


CASES = {
    "seq1_attention": (lambda: _acts(1, (B, D)), lambda: _seq1_args(2)),
    "gated_residual_seq1": (lambda: _acts(3, (B, D), (B, D)), lambda: _grb_args(4)),
    "mlp_head": (lambda: _acts(5, (B, HEAD[0])), lambda: _head_args(6)),
}


def _run_both(name, act_dtype):
    acts, weights = CASES[name][0](), CASES[name][1]()
    jdt = jnp.float32 if act_dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if act_dtype == "f32" else torch.bfloat16
    ref = getattr(jfk, name)(*[jnp.asarray(a, jdt) for a in acts],
                             *[jnp.asarray(w) for w in weights])
    out = getattr(tfk, name)(*[torch.from_numpy(a).to(tdt) for a in acts],
                             *[torch.from_numpy(w) for w in weights])
    assert out.dtype == tdt
    return np.asarray(ref.astype(jnp.float32)), out.float().numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_pallas_f32(name):
    ref, out = _run_both(name, "f32")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **F32_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_pallas_bf16(name):
    ref, out = _run_both(name, "bf16")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **BF16_TOL)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    tfk.reset_launches()
    acts, weights = CASES["seq1_attention"][0](), CASES["seq1_attention"][1]()
    args = [torch.from_numpy(a) for a in acts + weights]
    torch.testing.assert_close(tfk.seq1_attention(*args), tfk.seq1_attention_plain(*args),
                               rtol=0, atol=0)
    assert tfk.LAUNCHES == {"seq1_attention": 0, "gated_residual_seq1": 0, "metablock_film": 0,
                            "mlp_head": 0}


def test_other_devices_raise():
    kv = torch.zeros(2, D, device="meta")
    w = torch.zeros(D, D, device="meta")
    b = torch.zeros(D, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfk.seq1_attention(kv, w, b, w, b)


def _served(plan):
    for B in range(1, 65):
        rows = 1 if B == 1 else 8 if B <= 8 else 32
        assert plan(B, 512) == dict(kernel="seq1_cluster_kernel", cluster=16, rows=rows)


def _widths(plan):
    assert plan(1, 64)["cluster"] == 2 and plan(1, 448)["cluster"] == 14
    assert plan(3, 256) == dict(kernel="seq1_cluster_kernel", cluster=8, rows=8)


def _one_block(plan):
    for B, D, aligned in ((1, 768, True), (8, 480, True), (32, 576, True), (1, 512, False),
                          (8, 32, True), (33, 1024, True)):
        assert plan(B, D, aligned) == dict(kernel="seq1_attention_kernel", cluster=1,
                                           rows=1 if B < 4 else 4)


def _no_room(plan):
    asked = []

    def clusters(rows):
        asked.append(rows)
        return 0 if rows == 32 else 3

    assert plan(8, 512, True, clusters)["kernel"] == "seq1_cluster_kernel"
    assert plan(33, 512, True, clusters) == dict(kernel="seq1_attention_kernel", cluster=1,
                                                 rows=4)
    assert asked == [8, 32]
    assert plan(1, 768, True, asked.append)["kernel"] == "seq1_attention_kernel"
    assert asked == [8, 32]  # a width the route does not take asks nothing


@pytest.mark.parametrize("case", [_served, _widths, _one_block, _no_room],
                         ids=["served", "widths", "one_block", "no_room"])
def test_seq1_attention_plan(case):
    """K1's route, chosen in seq1_attention_plan alone: at the served width
    (D = 512) one cluster of 16 CTAs (32 output columns each) per tile of up
    to 32 rows, so that each weight element is read once per call at every
    served batch (B = 1, 8, 32); the one-block kernel at widths the cluster
    route does not take (not a multiple of 64, above 512, a weight not
    16-byte aligned) and where the card holds no such cluster."""
    case(tfk.seq1_attention_plan)


def _grb_served(plan):
    for B in range(1, 65):
        rows = 1 if B == 1 else 8 if B <= 8 else 16
        assert plan(B, 512) == dict(kernel="gated_residual_cluster_kernel", cluster=16, rows=rows)


def _grb_widths(plan):
    assert plan(1, 64)["cluster"] == 2 and plan(40, 448) == dict(
        kernel="gated_residual_cluster_kernel", cluster=14, rows=16)
    assert plan(3, 256) == dict(kernel="gated_residual_cluster_kernel", cluster=8, rows=8)


def _grb_one_block(plan):
    for B, D in ((1, 768), (8, 480), (32, 576), (8, 32), (33, 1024)):
        assert plan(B, D) == dict(kernel="gated_residual_kernel", cluster=1,
                                  rows=1 if B < 4 else 4)


def _grb_unaligned(plan):
    for B in (1, 8, 32):
        assert plan(B, 512, False) == dict(kernel="gated_residual_kernel", cluster=1,
                                           rows=1 if B < 4 else 4)


def _grb_no_room(plan):
    asked = []

    def clusters(rows):
        asked.append(rows)
        return 0 if rows == 16 else 7

    assert plan(8, 512, True, clusters)["kernel"] == "gated_residual_cluster_kernel"
    assert plan(9, 512, True, clusters) == dict(kernel="gated_residual_kernel", cluster=1, rows=4)
    assert asked == [8, 16]
    assert plan(1, 768, True, asked.append)["kernel"] == "gated_residual_kernel"
    assert asked == [8, 16]  # a width the route does not take asks nothing


@pytest.mark.parametrize("case", [_grb_served, _grb_widths, _grb_one_block, _grb_unaligned,
                                  _grb_no_room],
                         ids=["served", "widths", "one_block", "unaligned", "no_room"])
def test_gated_residual_plan(case):
    """K2's route, chosen in gated_residual_plan alone: at the served width
    (D = 512) one cluster of 16 CTAs (32 columns of all three products each)
    per tile of 1, 8 or 16 rows; the one-block kernel at widths the cluster
    route does not take, where a weight is not 16-byte aligned and where the
    card holds no such cluster."""
    case(tfk.gated_residual_plan)


def _film_served(plan):
    for Vd, ranks in ((2048, 16), (768, 12), (512, 16)):
        for B in range(1, 65):
            rows = 1 if B == 1 else 8 if B <= 8 else 32
            assert plan(B, 512, Vd) == dict(kernel="metablock_film_cluster_kernel",
                                            cluster=ranks, rows=rows)


def _film_widths(plan):
    # the narrowest of 32, 64 and 128 columns a modulator that makes at most 16 CTAs
    for Du, Vd, ranks in ((512, 96, 3), (512, 1024, 16), (512, 1536, 12), (128, 2048, 16),
                          (384, 256, 8), (256, 64, 2)):
        assert tfk.film_cluster_ranks(Du, Vd) == ranks
        assert plan(1, Du, Vd) == dict(kernel="metablock_film_cluster_kernel", cluster=ranks,
                                       rows=1)


def _film_one_block(plan):
    for B, Du, Vd in ((1, 512, 2560), (8, 512, 48), (32, 512, 4096), (1, 640, 512),
                      (8, 64, 512), (33, 520, 2048)):
        assert tfk.film_cluster_ranks(Du, Vd) == 0
        assert plan(B, Du, Vd) == dict(kernel="metablock_film_kernel", cluster=1,
                                       rows=1 if B < 4 else 4)


def _film_unaligned(plan):
    for B, Vd in ((1, 2048), (8, 768), (32, 512)):
        assert plan(B, 512, Vd, False) == dict(kernel="metablock_film_kernel", cluster=1,
                                               rows=1 if B < 4 else 4)


def _film_no_room(plan):
    asked = []

    def clusters(rows):
        asked.append(rows)
        return 0 if rows == 32 else 7

    assert plan(8, 512, 2048, True, clusters)["kernel"] == "metablock_film_cluster_kernel"
    assert plan(33, 512, 2048, True, clusters) == dict(kernel="metablock_film_kernel",
                                                       cluster=1, rows=4)
    assert asked == [8, 32]
    assert plan(1, 512, 2560, True, asked.append)["kernel"] == "metablock_film_kernel"
    assert asked == [8, 32]  # a width the route does not take asks nothing


@pytest.mark.parametrize("case", [_film_served, _film_widths, _film_one_block, _film_unaligned,
                                  _film_no_room],
                         ids=["served", "widths", "one_block", "unaligned", "no_room"])
def test_metablock_film_plan(case):
    """K4's route, chosen in metablock_film_plan alone: at the served widths
    (Du = 512; Vd 2048, 768, 512) one cluster of 16, 12 or 16 CTAs (128, 64
    or 32 columns of each modulator) per tile of 1, 8 or 32 rows, so that
    each weight element is read once per call up to B = 32; the one-block
    kernel at widths the cluster route does not take, where a weight is not
    16-byte aligned and where the card holds no such cluster."""
    case(tfk.metablock_film_plan)


def _head_served(plan):
    # the flagship's fused pair and metablock on ResNet-50's raw feature; x's
    # rows beside the ring leave room for 16 rows a tile at 1024, 8 at 2048
    for k1, largest in ((1024, 16), (2048, 8)):
        for B in range(1, 65):
            rows = 1 if B == 1 else 8 if B <= 8 else largest
            assert plan(B, k1, 512, 256, 6) == dict(kernel="mlp_head_cluster_kernel", cluster=16,
                                                    rows=rows)


def _head_widths(plan):
    # DaViT-tiny's metablock head; narrower heads on fewer CTAs; 32 rows a
    # tile where x is narrow enough
    assert plan(33, 768, 512, 256, 6) == dict(kernel="mlp_head_cluster_kernel", cluster=16,
                                              rows=16)
    assert plan(1, 256, 64, 32, 32) == dict(kernel="mlp_head_cluster_kernel", cluster=2, rows=1)
    assert plan(40, 512, 512, 256, 6) == dict(kernel="mlp_head_cluster_kernel", cluster=16,
                                              rows=32)
    assert plan(3, 2976, 448, 224, 6) == dict(kernel="mlp_head_cluster_kernel", cluster=14, rows=8)


def _head_one_block(plan):
    # N1 = 768 (24 CTAs), N1 not a multiple of 64, N2 not N1 / 2, K1 not a
    # multiple of 32, N3 above the route's 32, x too wide for 8 rows a tile
    for B, shape in ((1, (1024, 768, 384, 6)), (8, (1024, 480, 240, 6)), (32, (1024, 512, 128, 6)),
                     (1, (1000, 512, 256, 6)), (33, (1024, 512, 256, 33)),
                     (8, (4096, 512, 256, 6)), (1, (3008, 512, 256, 6))):
        assert plan(B, *shape) == dict(kernel="mlp_head_kernel", cluster=1,
                                       rows=1 if B < 4 else 4)


def _head_unaligned(plan):
    for B, k1 in ((1, 1024), (8, 2048), (32, 1024)):
        assert plan(B, k1, 512, 256, 6, False) == dict(kernel="mlp_head_kernel", cluster=1,
                                                       rows=1 if B < 4 else 4)


def _head_no_room(plan):
    asked = []

    def clusters(rows):
        asked.append(rows)
        return 0 if rows == 16 else 7

    assert plan(8, 1024, 512, 256, 6, True, clusters)["kernel"] == "mlp_head_cluster_kernel"
    assert plan(9, 1024, 512, 256, 6, True, clusters) == dict(kernel="mlp_head_kernel",
                                                              cluster=1, rows=4)
    assert asked == [8, 16]
    for shape in ((4096, 512, 256, 6), (1024, 768, 384, 6), (1024, 512, 256, 33)):
        assert plan(1, *shape, True, asked.append)["kernel"] == "mlp_head_kernel"
    assert asked == [8, 16]  # a width the route does not take asks nothing


@pytest.mark.parametrize("case", [_head_served, _head_widths, _head_one_block, _head_unaligned,
                                  _head_no_room],
                         ids=["served", "widths", "one_block", "unaligned", "no_room"])
def test_mlp_head_plan(case):
    """K3's route, chosen in mlp_head_plan alone: at the served widths
    (1024 or 2048 → 512 → 256 → 6, and DaViT-tiny's 768 → 512 → 256 → 6)
    one cluster of 16 CTAs (32 columns of fc1 and 16 of fc2 each) per tile of
    1, 8 or the most rows whose x fits beside the ring, each weight element
    read once per call at every batch a tile covers; the one-block kernel at
    widths the cluster route does not take, where a weight is not 16-byte
    aligned and where the card holds no such cluster. Every planned route's
    shared memory, as the Python mirror of the C formula computes it, fits
    in the 227 KB a block can use."""
    plans = []

    def plan(*args):
        plans.append((args, tfk.mlp_head_plan(*args)))
        return plans[-1][1]

    case(plan)
    for args, p in plans:
        if p["kernel"] == "mlp_head_cluster_kernel":
            k1, n1 = args[1], args[2]
            assert p["cluster"] * 32 == n1
            assert 4 * tfk.mlp_head_cluster_smem_floats(k1, n1, p["rows"]) <= 227 * 1024
