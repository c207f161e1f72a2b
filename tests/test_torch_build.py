"""The kernels' build: a library's name hashes its source and every shared
header, so an edited header never loads a stale library; and every kernel
name ``chip_smoke.py`` profiles is a kernel of the sources. No nvcc needed."""

import importlib.util
import re
from pathlib import Path

import pytest

from skinjax_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n__global__ void k() {}\n')
    (tmp_path / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return tmp_path


@pytest.mark.parametrize("edit", ["source", "header", "new header"])
def test_library_path_follows_source_and_headers(csrc, edit):
    before = build._library_path("kern")
    assert build._library_path("kern") == before  # stable while nothing changes
    target = {"source": "kern.cu", "header": "shared.cuh", "new header": "other.cuh"}[edit]
    with open(csrc / target, "a") as f:
        f.write("// edited\n")
    after = build._library_path("kern")
    assert after != before
    assert after.parent == csrc / "out" and after.name.startswith("libkern-")


def test_repo_sources_share_a_header():
    """The attention kernels and the fused MLP include the shared tensor-core
    header, which the hash covers, and keep no copy of its helpers; the
    fusion kernels' three cluster kernels share one set of building blocks."""
    headers = sorted(p.name for p in build.CSRC.glob("*.cuh"))
    assert "mma_bf16.cuh" in headers
    header = (build.CSRC / "mma_bf16.cuh").read_text()
    helpers = ("cp_async16", "cp_async_commit", "cp_async_wait", "load_tile", "pipeline",
               "warp_abt_step", "warp_ax_chunk", "pack_a_chunk")
    for name in ("global_attention", "pooled_attention", "fused_mlp", "window_attention",
                 "channel_attention"):
        source = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "mma_bf16.cuh"' in source
        assert "using bf16 =" not in source
        for helper in helpers:
            assert re.search(rf"\b{helper}\s*\(", header)
            assert not re.search(rf"void\s+{helper}\s*\(", source), (name, helper)
    # K7's bf16 forward and backward cores share steps (1) and (2), one
    # device function, so that their of agree bit for bit; K9/K10's bf16
    # forward issues its products through the backward's wgmma wrappers and
    # descriptors, its tiles coming by TMA
    window = (build.CSRC / "window_attention.cu").read_text()
    assert len(re.findall(r"void\s+wa_attend\s*\(", window)) == 1
    for kernel in ("wa_fwd_mma_kernel", "wa_bwd_mma_kernel"):
        body = window[window.index(f"{kernel}("):]
        body = body[:body.index("\n}\n")]
        assert "wa_attend<" in body, kernel
    # K8's bf16 projecting kernels share one projection routine, so every x
    # (and dy) step is read once for the columns of a block's heads
    channel = (build.CSRC / "channel_attention.cu").read_text()
    assert len(re.findall(r"void\s+project_tile\s*\(", channel)) == 1
    for kernel in ("ca_partial_mma_kernel", "ca_out_mma_kernel"):
        body = channel[channel.index(f"{kernel}("):]
        body = body[:body.index("\n}\n")]
        assert "project_tile<" in body, kernel
    mlp = (build.CSRC / "fused_mlp.cu").read_text()
    assert len(re.findall(r"void\s+wgmma_m64n64k16\s*\(", mlp)) == 1
    body = mlp[mlp.index("mlp_fwd_wgmma_kernel("):]
    body = body[:body.index("\n}\n")]
    for call in ("wgmma_m64n64k16<", "wgmma_desc(", "tma_load("):
        assert call in body, call
    # K1's, K2's, K4's and K3's cluster kernels are built from one set of blocks:
    # the slices' copies, the products, the fixed-order sums, the gather of a
    # product's columns and the LayerNorm's row statistics through distributed
    # shared memory, and one launch and occupancy query
    fusion = (build.CSRC / "fusion_kernels.cu").read_text()
    assert '#include "mma_bf16.cuh"' in fusion
    for helper in ("load_cols", "fetch_rows", "slice_step", "slice_part", "slice_sum",
                   "gather_columns", "row_stats", "cluster_config", "cluster_count",
                   "cluster_launch"):
        assert len(re.findall(rf"(?:void|float|cudaError_t)\s+{helper}\s*\(", fusion)) == 1, helper
    shared = ("fetch_rows<", "load_cols<", "slice_step<", "slice_part<", "slice_sum<")
    for kernel, calls in (("seq1_cluster_kernel", (*shared, "gather_columns<")),
                          ("gated_residual_cluster_kernel", (*shared, "gather_columns<",
                                                             "row_stats<")),
                          ("metablock_film_cluster_kernel", (*shared, "row_stats<")),
                          ("mlp_head_cluster_kernel", (*shared[1:], "gather_columns<",
                                                       "row_stats<"))):
        body = fusion[fusion.index(f"{kernel}("):]
        body = body[:body.index("\n}\n")]
        for call in calls:
            assert call in body, (kernel, call)


_PROFILED = ("KERNEL_NAMES", "K1_BLOCK_KERNEL", "BLOCK_KERNELS", "K5_KERNELS", "K7_KERNELS",
             "K7_F32",
             "MLP_KERNELS", "MLP_F32_FWD", "MLP_F32_BWD", "MLP_SPLIT",
             "K12_KERNELS", "K11_KERNELS", "K8_KERNELS", "K8_F32", "K7_PAD_KERNELS", "K6_KERNELS",
             "KERNEL_SYMBOLS")


def _names(value):
    if isinstance(value, str):
        return {value}
    if isinstance(value, dict):
        value = value.values()
    return set().union(*(_names(v) for v in value))


def test_profiled_kernel_names_are_kernels():
    """Every kernel name ``chip_smoke.py`` looks up in a profiler trace is a
    ``__global__`` function of ``skinjax_torch/csrc/*.cu``: a renamed kernel
    would otherwise leave its device time unmeasured without an error."""
    path = Path(build.CSRC).parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_names", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)  # torch is imported inside its functions only
    profiled = set().union(*(_names(getattr(smoke, name)) for name in _PROFILED))
    kernels = set()
    for source in build.CSRC.glob("*.cu"):
        kernels.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                                  r"(\w+)\s*\(", source.read_text()))
    assert {"mlp_bwd_act_wgmma_kernel", "mlp_bwd_dw_kernel", "ga_bwd_rows_mma_kernel",
            "ga_bwd_p_rows_mma_kernel", "ga_bwd_p_cols_mma_kernel", "ga_dbias_tiles_kernel",
            "pa_bwd_rows_mma_kernel", "pa_bwd_cols_mma_kernel", "wa_bwd_mma_kernel",
            "ga_fwd_mma_kernel", "wa_bwd_kernel", "ga_fwd_kernel", "wa_fwd_mma_kernel",
            "wa_proj_mma_kernel", "mlp_fwd_wgmma_kernel", "mlp_fwd_kernel"} <= kernels
    assert set(smoke.K12_KERNELS["global_attention_bwd"]) | set(
        smoke.K11_KERNELS["pooled_attention_bwd"]) <= kernels
    # the bf16 K7 strip backward and forward (both entries), K12's forward and
    # K9/K10's forward run on the tensor cores; the fp32 instantiations keep
    # the CUDA-core kernels, still profiled by name
    assert smoke.K7_KERNELS["window_attention_bwd"] == ["wa_bwd_mma_kernel"]
    assert smoke.K7_KERNELS["window_attention_fwd"] == ["wa_fwd_mma_kernel",
                                                        "wa_proj_mma_kernel"]
    assert smoke.K7_PAD_KERNELS[smoke.K7_PAD] == smoke.K7_KERNELS["window_attention_fwd"]
    assert smoke.MLP_KERNELS["fwd"] == ["mlp_fwd_wgmma_kernel"]
    assert smoke.K12_KERNELS["global_attention_fwd"] == ["ga_fwd_mma_kernel"]
    assert {"wa_bwd_kernel", "wa_fwd_kernel", "proj_kernel", "mlp_fwd_kernel",
            "ga_fwd_kernel"} <= set(smoke.KERNEL_SYMBOLS)
    # K8: the bf16 calls run the tensor-core kernels (and the softmax), the
    # fp32 instantiations keep the CUDA-core ones, all profiled by name
    assert smoke.K8_KERNELS == {
        "channel_attention_fwd": ["ca_partial_mma_kernel", "ca_softmax_kernel",
                                  "ca_out_mma_kernel"],
        "channel_attention_bwd": ["ca_partial_mma_kernel", "ca_softmax_kernel",
                                  "ca_grad_mma_kernel"]}
    assert smoke.K8_F32 == ["ca_partial_kernel", "ca_softmax_kernel", "ca_out_kernel",
                            "ca_proj_kernel", "ca_grad_kernel"]
    assert {*smoke.K8_F32, "ca_partial_mma_kernel", "ca_out_mma_kernel",
            "ca_grad_mma_kernel"} <= kernels & set(smoke.KERNEL_SYMBOLS)
    # K1 runs on a thread-block cluster at the served width and keeps the
    # one-block kernel at others, as seq1_attention_plan names them; K5's
    # kernel name is one constant, used wherever a trace is read
    from skinjax_torch.ops import fusion_kernels as fk

    assert smoke.KERNEL_NAMES["seq1_attention"] == fk.seq1_attention_plan(1, 512)["kernel"]
    assert smoke.K1_BLOCK_KERNEL == fk.seq1_attention_plan(1, smoke.K1_BLOCK_D)["kernel"]
    assert {"seq1_cluster_kernel", "seq1_attention_kernel"} <= kernels & set(smoke.KERNEL_SYMBOLS)
    # so do K2 and K4 (K4 at each served Vd), as gated_residual_plan and
    # metablock_film_plan name them; the widths their checks take the
    # one-block kernels at are ones the cluster routes do not take
    grb, film = "gated_residual_seq1", smoke.K4
    for B in (1, 8, 32):
        assert smoke.KERNEL_NAMES[grb] == fk.gated_residual_plan(B, 512)["kernel"]
        assert smoke.BLOCK_KERNELS[grb] == fk.gated_residual_plan(B, smoke.K1_BLOCK_D)["kernel"]
        for vd in smoke.K4_WIDTHS:
            assert smoke.KERNEL_NAMES[film] == fk.metablock_film_plan(B, smoke.K4_DU, vd)["kernel"]
        assert smoke.BLOCK_KERNELS[film] == fk.metablock_film_plan(
            B, smoke.K4_DU, smoke.K4_BLOCK_VD)["kernel"]
    assert smoke.ROUTE_WIDTHS[film][:-1] == smoke.K4_WIDTHS
    assert {"gated_residual_cluster_kernel", "gated_residual_kernel",
            "metablock_film_cluster_kernel", "metablock_film_kernel"} <= kernels & set(
        smoke.KERNEL_SYMBOLS)
    # so does K3 at both served input widths, as mlp_head_plan names it, and
    # keeps the one-block kernel at the width its route check takes it at
    head = smoke.K3
    for B in (1, 8, 32):
        for k1 in smoke.K3_WIDTHS:
            assert smoke.KERNEL_NAMES[head] == fk.mlp_head_plan(B, k1, *smoke.K3_HEAD)["kernel"]
        assert smoke.BLOCK_KERNELS[head] == fk.mlp_head_plan(B, smoke.K3_BLOCK_K1,
                                                             *smoke.K3_HEAD)["kernel"]
    assert smoke.ROUTE_WIDTHS[head] == (*smoke.K3_WIDTHS, smoke.K3_BLOCK_K1)
    assert {"mlp_head_cluster_kernel", "mlp_head_kernel"} <= kernels & set(smoke.KERNEL_SYMBOLS)
    assert smoke.K5_KERNELS == ["color_stage_kernel"]
    assert set(smoke.K5_KERNELS) <= kernels & set(smoke.KERNEL_SYMBOLS)
    assert path.read_text().count('"color_stage_kernel"') == 1
    assert sorted(profiled - kernels) == []

