"""Native (C++) host code, loaded with ctypes — the port's own copy of
``pipegcn_tpu/native/__init__.py`` (``available``, ``native_partition``,
``radix_argsort``, ``stable_argsort``) over byte-identical copies of its
two sources, ``partitioner.cpp`` (the multilevel k-way partitioner behind
``partition_graph(method='metis')`` and ``locality_clusters``) and
``halo_builder.cpp`` (the LSD radix argsort behind the host's O(E) sorts).

The library is compiled with g++ at first use into ``build/native/`` at
the root of the checkout (git-ignored), under a name that carries a hash
of the sources and the flags, so an edited source is rebuilt and a stale
library never loads; the package directory is never written. The policy
is the JAX package's: when g++ is missing or the build fails,
``available()`` is False and the callers take their numpy paths; setting
``PIPEGCN_NATIVE=0`` forces those paths. Both give a valid partition, but
not the same one: a run that must be on the native layout checks
``available()`` itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
_SOURCES = ("partitioner.cpp", "halo_builder.cpp")
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
BUILD_DIR = _DIR.parents[1] / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        h.update((_DIR / s).read_bytes())
    return BUILD_DIR / f"libpipegcn_native-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile the sources into ``path`` (through a temporary name and an
    atomic rename, so a concurrent process never loads half a file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in _SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            print(f"pipegcn_tpu_torch.native build failed:\n{res.stderr}",
                  file=sys.stderr)
            return False
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if tmp.exists():
            tmp.unlink()


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if os.environ.get("PIPEGCN_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
            _declare(lib)
        except (OSError, AttributeError):
            return None
        _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _declare(lib: ctypes.CDLL) -> None:
    c_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.pgt_partition.restype = ctypes.c_int
    lib.pgt_partition.argtypes = [
        ctypes.c_int64, c_i64p, c_i32p,          # n, indptr, indices
        ctypes.c_int32, ctypes.c_int,            # n_parts, objective
        ctypes.c_uint64, ctypes.c_double,        # seed, imbalance
        ctypes.c_int, c_i32p,                    # refine_iters, out
    ]
    lib.pgt_radix_argsort_u64.restype = ctypes.c_int
    lib.pgt_radix_argsort_u64.argtypes = [
        ctypes.c_int64, c_u64p, c_i64p,          # n, keys, out order
    ]


def native_partition(indptr: np.ndarray, indices: np.ndarray, n_parts: int,
                     obj: str = "vol", seed: int = 0,
                     imbalance: float = 1.05,
                     refine_iters: int = 10) -> np.ndarray:
    """Multilevel k-way partition of a symmetric CSR adjacency, int32
    ``[n]`` part ids. Raises RuntimeError when the library is
    unavailable: callers check :func:`available` first."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    out = np.empty(n, dtype=np.int32)
    rc = lib.pgt_partition(
        n, indptr, indices, np.int32(n_parts),
        1 if obj == "vol" else 0, np.uint64(seed), float(imbalance),
        int(refine_iters), out)
    if rc != 0:
        raise RuntimeError(f"pgt_partition failed with code {rc}")
    return out


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative integer keys: the native radix sort
    for arrays of at least 2**20 keys when the library is available, else
    numpy. Both give the same permutation."""
    if keys.size >= 1 << 20 and available():
        return radix_argsort(keys)
    return np.argsort(keys, kind="stable")


def radix_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative integer keys by the native LSD radix
    sort, the permutation of ``np.argsort(keys, kind='stable')``. Raises
    RuntimeError when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(keys.shape[0], dtype=np.int64)
    rc = lib.pgt_radix_argsort_u64(keys.shape[0], keys, out)
    if rc != 0:
        raise RuntimeError(f"pgt_radix_argsort_u64 failed with code {rc}")
    return out
