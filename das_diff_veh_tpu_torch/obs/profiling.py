"""Device memory gauges read from the CUDA caching allocator.

The port's counterpart of ``register_memory_gauges`` in
``das_diff_veh_tpu/obs/profiling.py``: the same families,
``das_device_bytes_in_use`` and ``das_device_peak_bytes``, labeled per
device, each evaluated lazily at scrape time from
``torch.cuda.memory_stats()`` (``allocated_bytes.all.current`` and
``allocated_bytes.all.peak``).  Without a card no device is wired and the
families stay registered, so the scrape shape is stable.  The profiler
window and the sampler thread of the JAX module are ROADMAP item 13.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from das_diff_veh_tpu_torch.obs.registry import MetricsRegistry


def register_memory_gauges(registry: MetricsRegistry,
                           devices: Optional[Sequence[int]] = None) -> int:
    """Lazy per-device memory gauges, labeled ``cuda:<index>``; returns the
    number of devices wired (every visible card by default, none without
    one)."""
    if devices is None:
        devices = range(torch.cuda.device_count()) if torch.cuda.is_available() else ()
    in_use = registry.gauge("das_device_bytes_in_use",
                            "allocator bytes in use", labels=("device",))
    peak = registry.gauge("das_device_peak_bytes",
                          "allocator peak bytes in use", labels=("device",))
    wired = 0
    for index in devices:
        lbl = f"cuda:{index}"
        in_use.labels(device=lbl).set_fn(
            lambda i=index: _stat(i, "allocated_bytes.all.current"))
        peak.labels(device=lbl).set_fn(lambda i=index: _stat(i, "allocated_bytes.all.peak"))
        wired += 1
    return wired


def _stat(index: int, key: str):
    return torch.cuda.memory_stats(index).get(key)
