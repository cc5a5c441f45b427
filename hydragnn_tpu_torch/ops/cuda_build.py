"""Build and load the CUDA library of K1 (``csrc/edge_pipeline.cu``).

No JAX counterpart (Pallas compiles inside ``jax.jit``). The source is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``. Nothing is built when this
module is imported: the first launch builds the library, and
``build(force=True)`` rebuilds it from the source.

The library goes to ``hydragnn_tpu_torch/csrc/build/`` (listed in
``.gitignore``), named by a hash of the source and flags, so an edited
source is rebuilt and a finished build is reused. A failed build raises
with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
BUILD_DIR = os.path.join(CSRC, "build")
SOURCE = os.path.join(CSRC, "edge_pipeline.cu")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# The last build in this process: {"seconds", "ptxas", "path"}.
build_report: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor in /usr/local/cuda/bin); "
        "the port's CUDA kernel is built at first use"
    )


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libedge_pipeline_{digest.hexdigest()[:12]}.so")


def build(force: bool = False) -> str:
    """Compile the library unless it is built already (always with
    ``force``); returns its path and records ``build_report``."""
    out = library_path()
    with _lock:
        if force or not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(
                    f"nvcc failed to build {SOURCE} (exit {proc.returncode}):\n"
                    f"{proc.stdout}"
                )
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
            build_report.update(
                seconds=time.perf_counter() - t0, ptxas=proc.stdout, path=out
            )
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library (built on first use), its C interface declared:
    every pointer and the stream as ``c_void_p`` (a bare Python int would
    be cut to 32 bits), sizes as ``c_int``."""
    global _lib
    if _lib is None:
        path = build()
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(path)
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.hg_edge_pipeline_fwd.argtypes = [p] * 8 + [i] * 10 + [p]
                lib.hg_edge_pipeline_fwd.restype = i
                lib.hg_cuda_error_string.argtypes = [i]
                lib.hg_cuda_error_string.restype = ctypes.c_char_p
                _lib = lib
    return _lib
