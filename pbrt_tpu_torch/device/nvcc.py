"""Build the port's CUDA kernels: nvcc -> shared library with a plain C
interface -> ctypes.

Each source in ``csrc/`` is compiled at first use into ``_build/`` next to
this package (git-ignored). The library name carries a hash of the flags,
the source and the shared headers it includes, so an edited kernel or header
is rebuilt. ``build_all`` starts one nvcc
per source at once, so a cold start pays for the slowest build only.

Every kernel is built for ``sm_90a`` with ``-fmad=false`` and without fast
math: the watertight triangle test needs each multiply and add rounded on
its own, and the kernels are held to their plain PyTorch twins.

The build and the launch counts are safe from several threads (the shards
of parallel/shard.py): one build runs at a time, and ``count_launch`` adds
to a wrapper's count under a lock.
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
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_LIBS: dict = {}  # source path -> {"lib", "seconds", "log", "path"}
_BUILD_LOCK = threading.Lock()  # one build_all at a time: two threads never run nvcc into one target
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to wrapper.launches (a launch wrapper's count), exactly when
    several threads launch at once."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources_of(source: Path) -> list[Path]:
    """The source and every header it includes with quotes, transitively
    (the shared csrc/*.cuh), each once, in include order."""
    out, todo = [], [source]
    while todo:
        f = todo.pop(0)
        if f in out:
            continue
        out.append(f)
        todo.extend(f.parent / name.decode() for name in _INCLUDE.findall(f.read_bytes()))
    return out


def _target(source: Path) -> Path:
    """The library path: a hash of the flags, the source and every header it
    includes, so an edit to a shared header rebuilds every library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources_of(source):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def build_all(sources) -> dict:
    """Compile (where needed) and load every source, all nvcc processes
    running at once. Returns {source: {"lib": ctypes.CDLL, "seconds": build
    wall time (0 when already built), "log": nvcc's -Xptxas -v output,
    "path": library path}}; raises RuntimeError naming a failed build."""
    sources = [Path(s) for s in sources]
    if all(str(s) in _LIBS for s in sources):  # the launch path: no lock and no file-system call once built
        return {s: _LIBS[str(s)] for s in sources}
    with _BUILD_LOCK:
        return _build_locked(sources)


def _build_locked(sources) -> dict:
    todo = [s for s in sources if str(s) not in _LIBS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for s in todo:
        so = _target(s)
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            procs[s] = (subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(s)],
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, so)
    errors = []
    for s in todo:
        seconds, log = 0.0, ""
        if s in procs:
            proc, tmp, so = procs[s]
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {s.name} ({proc.returncode}):\n{log}")
                continue
            os.replace(tmp, so)
        so = _target(s)
        _LIBS[str(s)] = {"lib": ctypes.CDLL(str(so)), "seconds": seconds, "log": log, "path": str(so)}
    if errors:
        raise RuntimeError("\n".join(errors))
    return {s: _LIBS[str(s)] for s in sources}


def build(source) -> dict:
    """build_all for one source."""
    return build_all([source])[Path(source)]


def occupancy(fn, *args) -> int:
    """Resident blocks per SM from a kernel library's ``*_occupancy`` entry,
    fn(*int args, int* blocks_per_sm) -> cudaError_t; raises on an error."""
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(*args, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return out.value
