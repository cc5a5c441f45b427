"""The native host library: the C++ cell list and the shared-memory sample store.

Counterpart of ``hydragnn_tpu/native/bindings.py``. The sources are the
port's own copies of the JAX package's (``csrc/host/celllist.cpp`` and
``csrc/host/samplestore.cpp``, the code unchanged), compiled with
``g++ -O3 -shared -fPIC -std=c++17`` (no ``-march=native``: the library
may be loaded on another CPU than the one that built it) at first use
into ``csrc/build/`` (gitignored), named by a digest of the sources and
the flags, as ``ops/cuda_build.py`` names the CUDA library. A build goes
to a per-process temporary path and is renamed into place, so ranks
building at once never load half a file. Nothing is built when this
module is imported.

- ``radius_graph_native`` / ``radius_graph_pbc_native``: the cell-list
  neighbour builders ``ops/neighbors.py`` dispatches to (they find the
  numpy path's edges, in another order; ``NativeUnsupported`` when the
  geometry does not suit dense bins, and the caller falls back);
- ``SampleStore``: a packed record store, in private memory or in POSIX
  shared memory that sibling processes attach read-only
  (``data/diststore.StoreDataset``).

``available()`` says whether the library built and loaded; where it did
not, ``build_error`` holds why and the neighbour builders take numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = tuple(
    os.path.join(_CSRC, "host", name) for name in ("celllist.cpp", "samplestore.cpp")
)
BUILD_DIR = os.path.join(_CSRC, "build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_FAILED = False
#: Why the library is unavailable (the compiler's output or the load
#: error); None while it builds and loads.
build_error: Optional[str] = None

#: The C++ sentinel: geometry the native path declines (fall back).
UNSUPPORTED = -(2**63)


class NativeUnsupported(Exception):
    """The native builder declined this input; use the numpy path."""


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libhgtpu_host_{digest.hexdigest()[:12]}.so")


def _build() -> Optional[ctypes.CDLL]:
    global build_error
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *CXX_FLAGS, *SOURCES, "-o", tmp]
        try:
            done = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
            if done.returncode != 0:
                build_error = f"{' '.join(cmd)} failed:\n{done.stdout}{done.stderr}"
            else:
                os.replace(tmp, out)
        except (OSError, subprocess.SubprocessError) as e:
            build_error = f"{' '.join(cmd)}: {e}"
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        if not os.path.exists(out):
            return None
    try:
        lib = ctypes.CDLL(out)
    except OSError as e:
        build_error = f"cannot load {out}: {e}"
        return None

    i64 = ctypes.c_int64
    p_d = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_i = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.hgtpu_radius_graph.restype = i64
    lib.hgtpu_radius_graph.argtypes = [p_d, i64, ctypes.c_double, i64, p_i, p_i]
    lib.hgtpu_radius_graph_pbc.restype = i64
    lib.hgtpu_radius_graph_pbc.argtypes = [
        p_d, i64, p_d, p_u8, ctypes.c_double, i64, p_i, p_i, p_d,
    ]
    lib.hgtpu_store_create.restype = ctypes.c_void_p
    lib.hgtpu_store_create.argtypes = [i64, i64, ctypes.c_char_p]
    lib.hgtpu_store_attach.restype = ctypes.c_void_p
    lib.hgtpu_store_attach.argtypes = [ctypes.c_char_p]
    lib.hgtpu_store_put.restype = i64
    lib.hgtpu_store_put.argtypes = [ctypes.c_void_p, i64, ctypes.c_char_p, i64]
    lib.hgtpu_store_num_records.restype = i64
    lib.hgtpu_store_num_records.argtypes = [ctypes.c_void_p]
    lib.hgtpu_store_record_size.restype = i64
    lib.hgtpu_store_record_size.argtypes = [ctypes.c_void_p, i64]
    lib.hgtpu_store_get.restype = ctypes.c_void_p
    lib.hgtpu_store_get.argtypes = [ctypes.c_void_p, i64, ctypes.POINTER(i64)]
    lib.hgtpu_store_close.restype = None
    lib.hgtpu_store_close.argtypes = [ctypes.c_void_p]
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_FAILED
    if _LIB is None and not _BUILD_FAILED:
        with _LOCK:
            if _LIB is None and not _BUILD_FAILED:
                _LIB = _build()
                _BUILD_FAILED = _LIB is None
    return _LIB


def available() -> bool:
    """Whether the library is built (now, if it was not) and loaded."""
    return _lib() is not None


def radius_graph_native(pos: np.ndarray, radius: float, capacity_hint: int = 0) -> np.ndarray:
    """edge_index [2, E] through the C++ cell list (capacity grown on
    demand); raises NativeUnsupported where the geometry is too sparse
    for dense bins."""
    lib = _lib()
    assert lib is not None
    pos = np.ascontiguousarray(pos, np.float64)
    n = pos.shape[0]
    cap = capacity_hint if capacity_hint > 0 else max(32 * n, 64)
    while True:
        snd = np.empty(cap, np.int64)
        rcv = np.empty(cap, np.int64)
        got = lib.hgtpu_radius_graph(pos, n, float(radius), cap, snd, rcv)
        if got == UNSUPPORTED:
            raise NativeUnsupported("geometry too sparse for dense bins")
        if got >= 0:
            return np.stack([snd[:got], rcv[:got]])
        cap = -got


def radius_graph_pbc_native(
    pos: np.ndarray,
    cell: np.ndarray,
    radius: float,
    pbc: Tuple[bool, bool, bool] = (True, True, True),
    capacity_hint: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(edge_index [2, E], shift vectors [E, 3]) through the C++ cell
    list; raises NativeUnsupported for a degenerate cell or too many
    images."""
    lib = _lib()
    assert lib is not None
    pos = np.ascontiguousarray(pos, np.float64)
    cell = np.ascontiguousarray(np.asarray(cell).reshape(3, 3), np.float64)
    flags = np.asarray([1 if p else 0 for p in pbc], np.uint8)
    n = pos.shape[0]
    cap = capacity_hint if capacity_hint > 0 else max(64 * n, 64)
    while True:
        snd = np.empty(cap, np.int64)
        rcv = np.empty(cap, np.int64)
        sh = np.empty((cap, 3), np.float64)
        got = lib.hgtpu_radius_graph_pbc(pos, n, cell, flags, float(radius), cap, snd, rcv, sh)
        if got == UNSUPPORTED:
            raise NativeUnsupported("degenerate cell / image explosion")
        if got >= 0:
            return np.stack([snd[:got], rcv[:got]]), sh[:got]
        cap = -got


class SampleStore:
    """Packed record store, optionally in POSIX shared memory.

    The owner: ``SampleStore(sizes, shm_name=...)``, then ``put`` each
    record in index order. A sibling process: ``SampleStore.attach(name)``
    maps the same memory read-only. ``get`` copies a record's bytes out.
    The owner's ``close`` unlinks the name, so a later attach fails."""

    def __init__(self, record_sizes, shm_name: Optional[str] = None):
        lib = _lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        sizes = [int(s) for s in record_sizes]
        self._handle = lib.hgtpu_store_create(
            len(sizes), int(sum(sizes)), shm_name.encode() if shm_name else None
        )
        if not self._handle:
            raise RuntimeError("store creation failed (name in use?)")

    @classmethod
    def attach(cls, shm_name: str) -> "SampleStore":
        obj = cls.__new__(cls)
        lib = _lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        obj._lib = lib
        obj._handle = lib.hgtpu_store_attach(shm_name.encode())
        if not obj._handle:
            raise RuntimeError(f"cannot attach shm store {shm_name!r}")
        return obj

    def put(self, i: int, data: bytes) -> None:
        got = self._lib.hgtpu_store_put(self._handle, i, data, len(data))
        if got < 0:
            raise ValueError(f"store_put failed for record {i}: {got}")

    def __len__(self) -> int:
        return int(self._lib.hgtpu_store_num_records(self._handle))

    def get(self, i: int) -> bytes:
        nbytes = ctypes.c_int64()
        ptr = self._lib.hgtpu_store_get(self._handle, i, ctypes.byref(nbytes))
        if not ptr:
            raise IndexError(i)
        return ctypes.string_at(ptr, nbytes.value)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hgtpu_store_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
