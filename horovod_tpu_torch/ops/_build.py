"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
Nothing is compiled when a module is imported: a library is built at its
first use, into ``ops/build/<hash>/`` (ignored by git), where the hash
covers the sources, the headers beside them and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class CallCounter:
    """A plain count of launches (or calls), kept beside the wrapper that
    makes them, so a run can show that its path went through them."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def sources() -> List[str]:
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    deps = [os.path.join(CSRC, name + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in deps:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], f"lib{name}.so")


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(lib_path, tmp_path, Popen or None)``."""
    lib = _lib_path(name)
    if os.path.exists(lib):
        return lib, None, None
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    # Build to a private name and rename: ranks building at once never
    # load a half-written library.
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _finish(name: str, lib: str, tmp, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(rc {proc.returncode}):\n{out}")
    os.replace(tmp, lib)


def build_all() -> Dict[str, float]:
    """Build every kernel source in parallel; returns seconds per source
    (0.0 for one already built)."""
    t0 = time.perf_counter()
    names = sources()
    started = [(n, *_start(n)) for n in names]
    times = {}
    try:
        for name, lib, tmp, proc in started:
            _finish(name, lib, tmp, proc)
            times[name] = (time.perf_counter() - t0) if proc else 0.0
    finally:
        for _, _, _, proc in started:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, tmp, proc = _start(name)
            _finish(name, path, tmp, proc)
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib
