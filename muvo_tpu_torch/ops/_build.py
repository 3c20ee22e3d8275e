"""Builds the port's CUDA sources on first use and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into a shared
library with a plain C interface under ``build/muvo_tpu_torch/`` at the root
of the checkout (git-ignored). All sources that need a build compile in
parallel, one nvcc each. A library is named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Only sources in the repository are compiled; nothing is fetched.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "muvo_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every csrc/*.cu whose library is missing, all at once.

    Returns {source name: seconds} for the sources built by this call. The
    compiler's output (including ``-Xptxas -v``'s registers and shared
    memory per kernel) is kept beside each library as ``<lib>.log``.
    """
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        try:
            for src in sorted(CSRC.glob("*.cu")):
                lib = _library_path(src)
                if lib.exists():
                    continue
                tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                log = open(lib.with_name(lib.name + ".log"), "w")
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=log, stderr=subprocess.STDOUT)
                jobs.append((src, lib, tmp, log, proc, time.perf_counter()))
            built, failed = {}, []
            for src, lib, tmp, log, proc, t0 in jobs:
                rc = proc.wait()
                log.close()
                if rc != 0:
                    failed.append(f"{src.name} (rc {rc}):\n"
                                  + lib.with_name(lib.name + ".log").read_text())
                    continue
                os.replace(tmp, lib)
                built[src.stem] = time.perf_counter() - t0
        finally:
            for *_, log, proc, _ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return built


def build_log(name: str) -> str:
    """The compiler output of csrc/<name>.cu's current library."""
    lib = _library_path(CSRC / f"{name}.cu")
    return lib.with_name(lib.name + ".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building the sources first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _library_path(CSRC / f"{name}.cu")
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
