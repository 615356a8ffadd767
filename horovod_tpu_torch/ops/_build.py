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
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List

from horovod_tpu_torch import telemetry

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_kernel_counters: List["CallCounter"] = []


def _publish_launches() -> None:
    for c in _kernel_counters:
        if c.count:
            telemetry.gauge(
                "hvd_kernel_launches",
                "Launches of a hand-written kernel by this process",
                kernel=c.name).set(float(c.count))


telemetry.register_metrics_flush_hook(_publish_launches)


class CallCounter:
    """A plain count of launches (or calls), kept beside the wrapper that
    makes them, so a run can show that its path went through them.  A
    ``kernel`` counter's count is also published at exit into the rank's
    metrics (``hvd_kernel_launches{kernel=<name>}``, once it is above 0),
    so a job's ``--metrics-file`` shows which kernels its ranks ran."""

    def __init__(self, name: str, kernel: bool = False):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()
        if kernel:
            _kernel_counters.append(self)

    def add(self) -> None:
        """One more; safe when several threads launch at once."""
        with self._lock:
            self.count += 1

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


def built(name: str) -> bool:
    """True when ``csrc/<name>.cu`` is built for its current source."""
    return os.path.exists(_lib_path(name))


def _spill_sites(sass: str) -> Dict[str, tuple]:
    """Per function of ``cuobjdump -sass`` output: its spill instructions
    (local loads and stores, LDL/STL) and how many of them lie inside a
    loop, the addresses from a branch's target up to the branch where the
    target lies behind it."""
    sites = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        spills, loops = [], []
        for m in re.finditer(r"/\*([0-9a-f]+)\*/\s+([^;]*);", body):
            addr, ins = int(m.group(1), 16), m.group(2)
            if re.search(r"\b(LDL|STL)\b", ins):
                spills.append(addr)
            b = re.search(r"\bBRA\S*\s+(0x[0-9a-f]+)", ins)
            if b and int(b.group(1), 16) <= addr:
                loops.append((int(b.group(1), 16), addr))
        sites[name.strip()] = (len(spills), sum(
            any(lo <= a <= hi for lo, hi in loops) for a in spills))
    return sites


def ptxas_report() -> List[dict]:
    """Each kernel instance's registers, stack frame, spill bytes and
    ptxas performance warnings (C7511: wgmma serialized for want of
    registers) as ``nvcc -Xptxas -v`` reports them under ``NVCC_FLAGS``,
    and its spill instructions in the SASS (``cuobjdump -sass``), all and
    those inside a loop: one dict a kernel, the name demangled by
    ``c++filt`` where the host has it.  Compiles into a temporary
    directory; the build cache is left alone."""
    rows = []
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        for name in sources():
            so = os.path.join(tmp, f"lib{name}.so")
            out = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
                 os.path.join(CSRC, name + ".cu")],
                capture_output=True, text=True, check=True).stderr
            sites = _spill_sites(subprocess.run(
                [cuobjdump, "-sass", so], capture_output=True, text=True,
                check=True).stdout)
            entry, warned, mine = None, {}, []
            for line in out.splitlines():
                m = re.search(r"\((C\d+)\).*in the function '(\w+)'", line)
                if m:
                    warned.setdefault(m.group(2), []).append(m.group(1))
                    continue
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    entry = {"source": name, "kernel": m.group(1)}
                    mine.append(entry)
                    continue
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
                if entry is not None and m:
                    entry.update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
                m = re.search(r"Used (\d+) registers", line)
                if entry is not None and m:
                    entry["registers"] = int(m.group(1))
            for r in mine:
                r["warnings"] = warned.get(r["kernel"], [])
                r["spill_ops"], r["spill_ops_in_loops"] = sites.get(
                    r["kernel"], (None, None))
            rows += mine
    filt = shutil.which("c++filt")
    if filt:
        names = subprocess.run([filt], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r["kernel"] = n
    return rows
