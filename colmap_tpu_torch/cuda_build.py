"""Build the port's CUDA sources at first use and load them with ctypes.

Each library is compiled by nvcc for sm_90a into a shared object with a
plain C interface (no PyTorch headers, so a build takes seconds), under
`colmap_tpu_torch/_build/`, keyed by a hash of its sources and flags. A
later process with the same sources loads the cached object.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# never --use_fast_math: inverse norms and the arccos epilogue stay IEEE
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}  # nvcc's messages (e.g. from -Xptxas -v)


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def load_library(name: str, sources: Sequence[str],
                 flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/, or absolute paths) with
    NVCC_FLAGS plus `flags` into lib<name>, once per content hash, and
    return the loaded library."""
    if name in _LIBS:
        return _LIBS[name]
    paths = [os.path.join(CSRC, s) for s in sources]
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *flags)).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, *paths]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
        build_logs[name] = res.stderr
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    build_seconds[name] = time.perf_counter() - t0
    _LIBS[name] = lib
    return lib


def ptx(source: str) -> str:
    """The PTX nvcc emits for `source` (a file name under csrc/), to check
    which instructions a kernel issues."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{source}.{os.getpid()}.ptx")
    res = subprocess.run([find_nvcc(), "-arch=compute_90a", "-std=c++17",
                          "-O3", "-ptx", "-o", out,
                          os.path.join(CSRC, source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc -ptx failed for {source}:\n{res.stderr}")
    with open(out) as f:
        text = f.read()
    os.remove(out)
    return text
