"""ctypes bindings for the host-side kNN of ``native/graphops.cpp`` (the
port's own loader, modelled on ``diffdock_tpu/native.py``).

The shared library is built at first use with ``g++`` into
``diffdock_tpu_torch/_build/`` (git-ignored), under a name that carries a
hash of the source and the flags, so an edited source builds anew:

    g++ -O3 -fPIC -shared -std=c++17 -fopenmp -o _build/libgraphops-<hash>.so native/graphops.cpp

Nothing is written into ``native/``. When the library cannot be built or
loaded, :func:`knn_graph_native` and :func:`knn_cross_native` return None
and the callers take their numpy path, as in the JAX package
(:func:`have_native` tells which path runs).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from diffdock_tpu_torch.utils.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "graphops.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp")

_lock = threading.Lock()
_lib = None
_tried = False
# why the library did not load (None once it loaded, or before the first try)
load_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgraphops-{digest}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}: {proc.stderr.strip()[-2000:]}")
    tmp.replace(out)


def _load():
    global _lib, _tried, load_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except Exception as exc:  # noqa: BLE001 - the numpy path takes over
            load_error = f"{type(exc).__name__}: {exc}"
            return None
        lib.knn_graph.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.knn_cross.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return _lib


def have_native() -> bool:
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def knn_graph_native(
    pos: np.ndarray, k: int, max_radius: Optional[float] = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Each point's k nearest other points (float32 squared distances),
    radius-capped with the nearest kept; None without the library."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, np.float32)
    n = pos.shape[0]
    k = min(k, max(n - 1, 1))
    idx = np.zeros((n, k), np.int32)
    mask = np.zeros((n, k), np.uint8)
    lib.knn_graph(
        _fptr(pos), n, k, ctypes.c_float(max_radius or -1.0),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return idx, mask.astype(bool)


def knn_cross_native(
    query: np.ndarray, ref: np.ndarray, k: int,
    max_radius: Optional[float] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Each query point's k nearest reference points; None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    query = np.ascontiguousarray(query, np.float32)
    ref = np.ascontiguousarray(ref, np.float32)
    nq, nr = query.shape[0], ref.shape[0]
    k = min(k, max(nr, 1))
    idx = np.zeros((nq, k), np.int32)
    mask = np.zeros((nq, k), np.uint8)
    lib.knn_cross(
        _fptr(query), nq, _fptr(ref), nr, k,
        ctypes.c_float(max_radius or -1.0),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return idx, mask.astype(bool)
