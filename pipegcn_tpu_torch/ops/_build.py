"""Build and load the port's hand-written CUDA kernels.

No JAX counterpart: XLA compiled the JAX package's device ops. Each
``ops/csrc/<name>.cu`` (which may include a ``csrc/*.cuh``) has a plain C
interface and is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``build/kernels/`` at the root of the checkout, at first
use, then loaded with ``ctypes``. The library file name carries a hash of
the source, so an edited kernel is rebuilt and a stale one never loads.

Nothing here runs at import time: the CPU tests import every module of
the port, and this machine need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    # the headers in csrc count too: a source may include one
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns seconds per name (0.0
    for a library that was already built). Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    running: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    secs: Dict[str, float] = {}
    for name in names:
        if _lib_path(name).exists():
            secs[name] = 0.0
            continue
        running.append((name, *_start(name)))
    errors = []
    for name, out, tmp, proc in running:
        log, _ = proc.communicate()
        secs[name] = time.monotonic() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use,
    with ``argtypes`` set from ``signatures`` (function -> ctypes
    argument types; every entry point returns an int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code (its
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
