"""The host-built constants of the chunk path, built once on the data's device.

Band-pass gains, the polyphase resample matrix, Savitzky-Golay taps, the
dispersion transform's frequency and velocity axes, the tracker's step
indices and axes, and the window batch's x axes are all computed on the host
from the chunk's geometry and configuration.  Copying them to the card on
every call costs one host-to-device copy each, and a CUDA graph cannot take
such a copy at all: the copy from pageable memory synchronises, and the graph
would keep a pointer to host memory that is later freed.

:func:`device_constant` builds each one once per (key, dtype, device) and
hands the same tensor out on every later call; :func:`host_constant` keys a
host array on its values (a SHA-1 fingerprint).  A cached tensor is shared by
every caller, so nobody writes it in place.  The fused chunk
(``pipeline.fused``) fills the cache in its warm-up call, before capture.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Hashable

import numpy as np
import torch

_CACHE: dict = {}
_LOCK = threading.Lock()


def fingerprint(a) -> tuple:
    """``(shape, dtype, sha1 of the bytes)`` of a host array."""
    a = np.ascontiguousarray(a)
    return a.shape, a.dtype.str, hashlib.sha1(a.tobytes()).hexdigest()


def device_constant(key: Hashable, build: Callable[[], np.ndarray], dtype: torch.dtype,
                    device) -> torch.Tensor:
    """The host array ``build()`` as a ``dtype`` tensor on ``device``, built
    and copied on the first call for ``key`` only.  ``key`` must name every
    host value that ``build`` depends on."""
    full = (key, dtype, torch.device(device))
    out = _CACHE.get(full)
    if out is None:
        out = torch.tensor(np.ascontiguousarray(build()), dtype=dtype, device=device)
        with _LOCK:
            out = _CACHE.setdefault(full, out)
    return out


def host_constant(a, dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`device_constant` of the host array ``a``, keyed on its values."""
    a = np.asarray(a)
    return device_constant(("values", *fingerprint(a)), lambda: a, dtype, device)


def n_constants() -> int:
    """Tensors in the cache."""
    return len(_CACHE)


def nbytes(device=None) -> int:
    """Bytes the cached tensors hold (on ``device`` only, when given)."""
    dev = None if device is None else torch.device(device)
    return sum(t.numel() * t.element_size() for (_, _, d), t in list(_CACHE.items())
               if dev is None or d == dev)


def clear() -> None:
    """Drop every cached tensor; the next call of each site builds it again."""
    with _LOCK:
        _CACHE.clear()
