"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``skinjax_torch/csrc/`` have a plain C interface, so they
compile in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/skinjax_torch/lib<name>-<hash>.so csrc/<name>.cu

The library goes into ``build/skinjax_torch/`` beside the package, on first
use. Its file name carries a hash of the source, of every shared header
``csrc/*.cuh`` (a source may include any of them) and of the flags, so an
edited source or header builds anew and a stale library is never loaded.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "skinjax_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when the library was already built), "log": nvcc's stderr}
build_info: Dict[str, Dict] = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists; return the path."""
    lib = _library_path(name)
    if lib.exists():
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {name}.cu:\n{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": proc.stderr}
    return lib


def load(name: str, signatures: Dict) -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures:
    ``signatures`` maps a function name to ``(argtypes, restype)``."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return _loaded[name]
