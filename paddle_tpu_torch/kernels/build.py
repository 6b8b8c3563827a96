"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``kernels/csrc/`` compiles on first use into its own
shared library with a plain C interface,
``build/paddle_tpu_torch/<name>-<hash>.so`` at the repository root, where
``<hash>`` covers the source text, the shared headers (``csrc/*.cuh``)
and the nvcc flags: an edited source or header builds anew, an unchanged
one loads the library already built. The
target is ``sm_90a`` (Hopper; ``wgmma`` and ``setmaxnreg`` need the
``a``). A failed build raises :class:`KernelBuildError` with nvcc's
output; nothing falls back to another implementation.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine with no nvcc.
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
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every kernel source of the port, by library name
SOURCES = {"flash_attention_fwd": CSRC / "flash_attention_fwd.cu",
           "flash_attention_bwd": CSRC / "flash_attention_bwd.cu",
           "conv_epilogue": CSRC / "conv_epilogue.cu"}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.is_file():
        return str(cand)
    raise KernelBuildError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the port's CUDA kernels")


def library_path(name: str) -> Path:
    """The library built from ``name``'s source, the shared headers under
    ``csrc/`` and the nvcc flags: a change to any of them builds anew."""
    text = SOURCES[name].read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """nvcc's output (ptxas registers, shared memory, spills) of the last
    build of ``name``."""
    return BUILD_DIR / f"{name}.log"


def _start(nvcc: str, name: str):
    """Start nvcc on ``name``'s source, writing to a temporary file."""
    so = library_path(name)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, time.perf_counter()


def _finish(name: str, job) -> float:
    """Wait for ``name``'s nvcc; returns its seconds or raises."""
    proc, tmp, so, t0 = job
    out, _ = proc.communicate()
    log_path(name).write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {SOURCES[name].name} "
                               f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return time.perf_counter() - t0


def build_all(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Build every named library that is not built yet, one nvcc per
    source, all started together, and wait for all of them. Returns the
    build seconds of those built now."""
    with _lock:
        todo = [n for n in names if not library_path(n).is_file()]
        if not todo:
            return {}
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {n: _start(nvcc, n) for n in todo}
        seconds, errors = {}, []
        for name, job in jobs.items():
            try:
                seconds[name] = _finish(name, job)
            except KernelBuildError as exc:
                errors.append(str(exc))
        if errors:
            raise KernelBuildError("\n".join(errors))
        return seconds


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
