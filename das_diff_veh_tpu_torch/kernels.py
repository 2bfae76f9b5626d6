"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root, keyed by a hash of the source, and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Only
the sources in the checkout are used.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("traj_gather", "traj_dot", "cross_spectra", "lag_absmax")

_LIBS: dict = {}
build_seconds: dict = {}     # name -> nvcc wall time of this process's build
build_log: dict = {}         # name -> nvcc output (ptxas register/spill report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is already built;
    returns ``(proc or None, tmp, target, t0)``."""
    target = _target(name)
    if target.exists():
        return None, None, target, time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, target, t0


def _finish(name: str, proc, tmp, target, t0) -> None:
    """Wait for the build of ``name`` (if one was started) and load it."""
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out.decode()}")
        os.replace(tmp, target)
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = out.decode()
    _LIBS[name] = ctypes.CDLL(str(target))


def build_all(names=SOURCES) -> None:
    """Compile and load every kernel source, one nvcc process per source,
    all started together."""
    started = [(n, *_start(n)) for n in names if n not in _LIBS]
    for n, *job in started:
        _finish(n, *job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _LIBS:
        build_all((name,))
    return _LIBS[name]
