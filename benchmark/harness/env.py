"""The process environment of a run, fixed before numpy or torch loads.

- Libraries that can load JAX by themselves are kept from doing so.
- Every build and kernel cache of the program stays inside the checkout,
  at a fixed path, so that only a cell's first run there builds.
- One thread for OpenMP, MKL and OpenBLAS: the host work of a cell (the
  loader, the admission screen) runs on a few threads of its own, and idle
  worker threads that spin for work would take cores from them and make
  runs differ.
"""

import os
from pathlib import Path

HOST_THREADS = "1"


def fix(root: Path) -> None:
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    caches = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}
    for key, name in caches.items():
        path = root / "build" / name
        path.mkdir(parents=True, exist_ok=True)   # PyTorch makes no parents
        os.environ[key] = str(path)
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = HOST_THREADS
