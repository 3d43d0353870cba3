"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and does not
include PyTorch's headers, so one ``nvcc`` call builds it in seconds; the
``.cu`` files may share ``.cuh`` headers of ``csrc/``.  The
build runs at first use, into ``rdm_tpu_torch/_build/``; the library's file
name carries a hash of the source, the shared headers and the flags, so a
stale build is never loaded.  ``nvcc`` is looked up under ``$CUDA_HOME/bin`` and then
``/usr/local/cuda/bin``; without it the build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory one block may use on sm_90 (227 KB).
SMEM_LIMIT = 232448
# Serialises the first load of a library (and the typing of its functions):
# the threads of a solve split over cards reach their first launch together.
_LOAD_LOCK = threading.Lock()


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
    """The library's path; its name hashes the source, every shared header
    of ``csrc/`` and the flags, so an edit to any of them forces a build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(*names: str) -> list:
    """Compile each ``csrc/<name>.cu`` whose current library does not exist,
    one ``nvcc`` per source, all started together; return the libraries'
    paths.  The compiler's resource report (``-Xptxas -v``) is kept beside
    each library as ``.log``."""
    paths = [library_path(n) for n in names]
    jobs = []
    for name, path in zip(names, paths):
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                     os.path.join(CSRC_DIR, name + ".cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{out}")
            continue
        with open(path[:-3] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it, once a process: a
    thread that calls while another builds waits for that build."""
    with _LOAD_LOCK:
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name)[0])


def library(name: str, fn_name: str, argtypes, extra=()):
    """``load_library(name)`` with the types of ``fn_name`` (a launcher that
    returns a ``cudaError_t`` as int), of ``rdm_cuda_error_string`` and of
    each ``(name, argtypes, restype)`` of ``extra`` set on first use."""
    lib = load_library(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        with _LOAD_LOCK:
            if fn.argtypes is None:
                fn.restype = ctypes.c_int
                lib.rdm_cuda_error_string.argtypes = [ctypes.c_int]
                lib.rdm_cuda_error_string.restype = ctypes.c_char_p
                for fname, args, res in extra:
                    getattr(lib, fname).argtypes = args
                    getattr(lib, fname).restype = res
                fn.argtypes = argtypes   # last: the check above reads it
    return lib


def raise_on(lib, err: int, name: str) -> None:
    """Raise with CUDA's message unless the launcher returned 0."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: " + lib.rdm_cuda_error_string(err).decode())
