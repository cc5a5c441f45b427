"""Build and load the CUDA library of K1 and K2.

No JAX counterpart (Pallas compiles inside ``jax.jit``). The sources
(``csrc/edge_pipeline.cu``: K1, the fused edge pipeline;
``csrc/edge_pipeline_bwd.cu``: K2, its pullback; both include the
shared device code in ``csrc/edge_tile.cuh``) are compiled for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``. Nothing is built when this module is imported: the first
launch builds the library, and ``build(force=True)`` rebuilds it from
the sources. ``compile_library`` builds any other set of sources the
same way (``chip_smoke.py`` uses it to time an earlier version of the
kernels beside these).

The library goes to ``hydragnn_tpu_torch/csrc/build/`` (listed in
``.gitignore``), named by a hash of the sources, the header and the
flags, so an edited source is rebuilt and a finished build is reused. A
failed build raises with the compiler's output; there is no fallback.
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
SOURCES = tuple(
    os.path.join(CSRC, name) for name in ("edge_pipeline.cu", "edge_pipeline_bwd.cu")
)
HEADERS = (os.path.join(CSRC, "edge_tile.cuh"),)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libedge_pipeline_{digest.hexdigest()[:12]}.so")


def _run_all(commands) -> list:
    """Start every command at once and wait for all of them: (exit
    code, merged output) per command."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands
    ]
    results = []
    for p in procs:
        output = p.communicate()[0]
        results.append((p.returncode, output))
    return results


def compile_library(sources, out: str) -> dict:
    """Compile ``sources`` (one nvcc each, started together) and link them
    into the shared library ``out``; returns {"seconds", "ptxas", "path"}.
    Raises with the compiler's output if any step fails."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        results = _run_all(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(sources, objs)
        )
        if all(rc == 0 for rc, _ in results):
            results += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        failed = [(rc, o) for rc, o in results if rc != 0]
        if failed:
            raise RuntimeError(
                f"nvcc failed to build {', '.join(sources)} (exit "
                f"{failed[0][0]}):\n" + "\n".join(o for _, o in results)
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for path in (tmp, *objs):
            if os.path.exists(path):
                os.remove(path)
    return {"seconds": time.perf_counter() - t0,
            "ptxas": "".join(o for _, o in results), "path": out}


def build(force: bool = False) -> str:
    """Compile the library unless it is built already (always with
    ``force``); returns its path and records ``build_report``."""
    out = library_path()
    with _lock:
        if force or not os.path.exists(out):
            build_report.update(compile_library(SOURCES, out))
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
                lib.hg_edge_pipeline_bwd.argtypes = [p] * 13 + [i] * 10 + [p]
                lib.hg_edge_pipeline_bwd.restype = i
                shape = ctypes.POINTER(ctypes.c_int)
                lib.hg_edge_pipeline_fwd_shape.argtypes = [i] * 7 + [shape]
                lib.hg_edge_pipeline_fwd_shape.restype = None
                lib.hg_edge_pipeline_bwd_shape.argtypes = [i] * 8 + [shape]
                lib.hg_edge_pipeline_bwd_shape.restype = None
                lib.hg_cuda_error_string.argtypes = [i]
                lib.hg_cuda_error_string.restype = ctypes.c_char_p
                _lib = lib
    return _lib
