"""Pipelined batch-execution runtime (a copy of ``das_diff_veh_tpu/runtime``).

Four concerns, one module each:

- :mod:`prefetch` — bounded-queue background loader overlapping host npz
  read + preprocess + staging onto the card with device compute;
- :mod:`executor` — per-chunk retry/backoff and quarantine (a corrupt file
  costs one chunk, not the date), ordered bit-exact accumulation;
- :mod:`manifest` — config-hash-keyed resume manifest + partial-state
  checkpoints for exact mid-date restart;
- :mod:`tracing` — Chrome-trace-format JSONL span events and throughput
  counters.

The batch workflows (``pipeline.workflow``) and the CLI are thin callers of
this package; it has no knowledge of DAS specifics beyond "a chunk loads,
computes, accumulates".
"""

from das_diff_veh_tpu_torch.runtime.config import RuntimeConfig
from das_diff_veh_tpu_torch.runtime.executor import (ChunkTask, ExecStats,
                                                     QuarantineRecord,
                                                     consult_tuner, run_pipelined)
from das_diff_veh_tpu_torch.runtime.manifest import RunManifest, config_hash
from das_diff_veh_tpu_torch.runtime.prefetch import PrefetchLoader
from das_diff_veh_tpu_torch.runtime.tracing import (NullTracer, TraceWriter,
                                                    load_trace, make_tracer)

__all__ = [
    "RuntimeConfig", "ChunkTask", "ExecStats", "QuarantineRecord",
    "consult_tuner", "run_pipelined", "RunManifest", "config_hash",
    "PrefetchLoader", "NullTracer", "TraceWriter", "load_trace",
    "make_tracer",
]
