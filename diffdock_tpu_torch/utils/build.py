"""Build hand-written CUDA kernels with plain ``nvcc`` and load them.

Each kernel source in ``csrc/`` exposes a plain C interface and is compiled
at first use into ``diffdock_tpu_torch/_build/`` (git-ignored) as a shared
library loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the flags, the sources and the headers of
``csrc/`` they include (``#include "name.cuh"``, followed through headers
that include others), so an edited source or header builds anew and an
unchanged one loads the library already built. No PyTorch headers are
included: a build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# the compiler's report (registers, shared memory, spills) of each build
# done by this process, by library name
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelBuildError("nvcc not found: CUDA kernels build only where the CUDA toolkit is installed")
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(sources: Sequence[str]) -> List[str]:
    """``sources`` and every header of ``csrc/`` they include, each once, in
    the order first met."""
    seen: List[str] = []
    todo = list(sources)
    while todo:
        src = todo.pop(0)
        if src in seen:
            continue
        seen.append(src)
        todo.extend(m.decode() for m in _LOCAL_INCLUDE.findall((CSRC_DIR / src).read_bytes()))
    return seen


def library_path(name: str, sources: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in source_files(sources):
        h.update(src.encode())
        h.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[str], verbose: bool = True) -> Path:
    """Compile ``sources`` (relative to ``csrc/``) into a shared library
    unless a library of the same sources exists; returns its path."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(CSRC_DIR / s) for s in sources]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed ({proc.returncode}) for {name}:\n{log}")
    os.replace(tmp, out)
    build_logs[name] = log
    if verbose:
        print(f"[build] {out.name}: nvcc {dt:.1f} s", flush=True)
    return out


def build_all(libraries: Mapping[str, Sequence[str]]) -> Dict[str, Path]:
    """Build several libraries at once, one ``nvcc`` each, all started
    together; returns each library's path (raises the first failure)."""
    with ThreadPoolExecutor(max_workers=max(len(libraries), 1)) as pool:
        futures = {name: pool.submit(build, name, srcs) for name, srcs in libraries.items()}
        return {name: f.result() for name, f in futures.items()}


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build if needed and load the library once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _loaded[name] = lib
        return lib
