"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and does not
include PyTorch's headers, so one ``nvcc`` call builds it in seconds.  The
build runs at first use, into ``rdm_tpu_torch/_build/``; the library's file
name carries a hash of the source and the flags, so a stale build is never
loaded.  ``nvcc`` is looked up under ``$CUDA_HOME/bin`` and then
``/usr/local/cuda/bin``; without it the build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(f"nvcc not found (looked at {candidates}); set CUDA_HOME")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current library exists; return
    the library's path.  The compiler's resource report (``-Xptxas -v``) is
    kept beside the library as ``.log``."""
    path = library_path(name)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                               os.path.join(CSRC_DIR, name + ".cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        with open(path[:-3] + ".log", "w") as f:
            f.write(proc.stdout)
        os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(build(name))
