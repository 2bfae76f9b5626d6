"""Observability: one registry, a flight recorder, a metrics sink, and the
device memory gauges (the batch-run part of ``das_diff_veh_tpu/obs``).

- :mod:`registry` — thread-safe counters/gauges/bounded-ring histograms
  with labeled families, rendered as Prometheus text and as JSON;
- :mod:`sink` — periodic JSONL snapshots for batch runs (no scraper);
- :mod:`flight` — bounded ring of recent per-chunk records dumped to a JSON
  artifact on quarantine or SIGTERM;
- :mod:`profiling` — ``das_device_bytes_in_use`` / ``das_device_peak_bytes``
  gauges read from ``torch.cuda.memory_stats()``.

The files keep the JAX package's formats, so ``scripts/obs_report.py``
renders a port run's trace, metrics and flight dump unchanged.  Not ported
yet (ROADMAP item 13): the profiler window, the memory sampler thread and
the compile/trace event counters (``obs/xla_events.py``).
"""

from das_diff_veh_tpu_torch.obs.flight import FlightRecorder, load_flight_dump
from das_diff_veh_tpu_torch.obs.profiling import register_memory_gauges
from das_diff_veh_tpu_torch.obs.registry import (MetricsRegistry, default_registry,
                                                 percentile)
from das_diff_veh_tpu_torch.obs.sink import MetricsSink, load_metrics_jsonl

__all__ = [
    "MetricsRegistry", "default_registry", "percentile",
    "MetricsSink", "load_metrics_jsonl",
    "register_memory_gauges",
    "FlightRecorder", "load_flight_dump",
]
