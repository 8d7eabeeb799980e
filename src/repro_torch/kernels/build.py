"""Build and load the port's CUDA sources: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each library is built at first use into ``build/repro_torch/`` at the root
of the checkout, under a name keyed by a hash of its sources and flags, so
a changed source builds anew and an unchanged one is loaded as it is.  A
missing ``nvcc`` or a failed build raises.  ``load_count`` counts library
loads per name: serving across register rewrites must keep it at 1, since
registers are kernel arguments, never compile-time constants.

Every launcher takes PyTorch's current stream (:func:`stream`).
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

import torch

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


def _start_build(name: str, sources: Sequence[pathlib.Path]):
    """Start ``nvcc`` for library ``name`` into a temporary file; returns
    (process, temporary path, final path, start time)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, library_path(name, sources), time.perf_counter()


def _finish_build(name: str, job) -> None:
    proc, tmp, path, t0 = job
    _, err = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{err}")
    os.replace(tmp, path)


def build_libraries(libs: Dict[str, Sequence[pathlib.Path]]) -> None:
    """Build every library of ``libs`` (name -> sources) that is not built
    yet, one ``nvcc`` per library, all started together."""
    jobs = {name: _start_build(name, srcs) for name, srcs in libs.items()
            if name not in _LIBS and not library_path(name, srcs).exists()}
    try:
        for name, job in jobs.items():
            _finish_build(name, job)
    finally:
        for proc, tmp, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def load_library(name: str, sources: Sequence[pathlib.Path]) -> ctypes.CDLL:
    """The loaded library ``name``, built from ``sources`` if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name, sources)
    if not path.exists():
        _finish_build(name, _start_build(name, sources))
    lib = ctypes.CDLL(str(path))
    _LIBS[name] = lib
    load_count[name] = load_count.get(name, 0) + 1
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the launchers take it:
    the raw handle, without building a ``torch.cuda.Stream`` on every call."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
