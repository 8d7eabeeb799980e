"""Build and load the port's CUDA sources: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each library is built at first use into ``build/repro_torch/`` at the root
of the checkout, under a name keyed by a hash of its sources and flags, so
a changed source builds anew and an unchanged one is loaded as it is.  A
missing ``nvcc`` or a failed build raises.  ``load_count`` counts library
loads per name: serving across register rewrites must keep it at 1, since
registers are kernel arguments, never compile-time constants.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Sequence

ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
load_count: Dict[str, int] = {}
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on a machine with the CUDA toolkit")
    return nvcc


def library_path(name: str, sources: Sequence[pathlib.Path]) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str, sources: Sequence[pathlib.Path]) -> ctypes.CDLL:
    """The loaded library ``name``, built from ``sources`` if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name, sources)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    _LIBS[name] = lib
    load_count[name] = load_count.get(name, 0) + 1
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
