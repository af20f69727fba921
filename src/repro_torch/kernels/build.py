"""Build and load the port's CUDA libraries.

Each kernel source ``csrc/<name>.cu`` has a plain C interface and becomes
its own shared library, compiled by ``nvcc`` for sm_90a at first use into
``build/repro_torch/lib<name>-<digest>.so`` at the repository root (the
digest is of the source and the headers beside it, ``csrc/*.cuh``, so an
edited source or header builds anew) and loaded with
ctypes.  ``ptxas -v``'s register and shared-memory report lands beside it
as ``<library>.log``.  Nothing builds when a module is imported: the CPU
tests import every module, and the CPU has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    CSRC))), "build", "repro_torch")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the kernels "
                           "build from src/repro_torch/csrc at first use")
    return found


def build_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` for sm_90a unless a library built from the
    same source and headers exists; returns the ``.so`` path.  Several
    sources may build at once, each in its own thread."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({r.returncode}):\n"
                           f"{r.stderr}")
    with open(out + ".log", "w") as f:          # ptxas register/smem report
        f.write(r.stderr)
    os.replace(tmp, out)
    return out


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at the first call;
    ``bind`` declares its entry points' ``argtypes`` / ``restype`` once."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_library(name))
            bind(lib)
            _libs[name] = lib
        return _libs[name]
