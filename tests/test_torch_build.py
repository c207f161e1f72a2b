"""The kernels' build: a library's name hashes its source and every shared
header, so an edited header never loads a stale library. No nvcc needed."""

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
    """The attention kernels include the shared tensor-core header, which the
    hash covers."""
    headers = sorted(p.name for p in build.CSRC.glob("*.cuh"))
    assert "mma_bf16.cuh" in headers
    for name in ("global_attention", "pooled_attention"):
        assert '#include "mma_bf16.cuh"' in (build.CSRC / f"{name}.cu").read_text()
