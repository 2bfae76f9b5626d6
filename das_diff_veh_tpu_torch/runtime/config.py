"""Execution-runtime knobs, separate from the numerical PipelineConfig
(a copy of ``das_diff_veh_tpu/runtime/config.py``, field for field and
default for default).

PipelineConfig is the physics; RuntimeConfig is how the batch
loop *executes* — prefetch depth, retry policy, manifest cadence, tracing.
Changing it never changes a single output bit, so it is deliberately
excluded from the resume manifest's config hash.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from das_diff_veh_tpu_torch.config import ObsConfig


@dataclass(frozen=True)
class RuntimeConfig:
    """How the pipelined batch executor runs one directory of chunks."""

    prefetch_depth: int = 2
    """Chunks the background loader may stage ahead of the card (bounded
    queue).  0 disables the loader thread entirely: loads run inline on the
    main thread (the serial reference behavior, and the serial baseline)."""

    max_retries: int = 1
    """Extra attempts per chunk per stage (load and compute retry
    independently) before the chunk is quarantined."""

    retry_backoff_s: float = 0.05
    """Sleep before retry attempt k is ``k * retry_backoff_s`` (linear
    backoff; transient NFS/device hiccups clear in well under a second)."""

    retry_quarantined: bool = False
    """Resume policy for chunks the manifest already recorded as
    quarantined.  False (default): a restart *skips* known-bad chunks —
    they settled once through the full retry ladder and re-failing them on
    every restart would turn one bad file into a per-restart tax.  True:
    their quarantine records are cleared and they re-enter the work list
    (use after fixing the underlying fault — a restored NFS mount, a
    repaired file)."""

    device_put: bool = True
    """Stage the loaded waterfall onto the run's device from the loader
    thread: on the card, cast to float32, pinned, and copied on a side
    stream (``pipeline.workflow``), overlapping the host-to-device copy with
    compute.  On the CPU the section keeps the reader's dtype."""

    state_every: int = 1
    """Write the resume manifest + partial-accumulator state every N
    completed chunks.  1 (default) gives exact single-chunk-granularity
    resume; raise it if manifest I/O ever shows up in traces."""

    trace_path: Optional[str] = None
    """Write Chrome-trace-format JSONL span events here (read / preprocess /
    compute / accumulate, plus throughput counters).  None disables."""

    obs: ObsConfig = field(default_factory=ObsConfig)
    """Observability knobs for the batch run: metrics JSONL sink,
    flight-recorder dumps on quarantine/SIGTERM, the steady-state profiler
    window, trace flush batching (see
    :class:`~das_diff_veh_tpu_torch.config.ObsConfig`)."""

    tuner_store: Optional[str] = None
    """Path to a tuner-store JSON.  The port has no tuner yet (ROADMAP item
    13): :func:`~das_diff_veh_tpu_torch.runtime.executor.consult_tuner`
    raises ``NotImplementedError`` when this is set.  None (default):
    defaults run untouched.  Living here is
    consistent with the PipelineConfig/RuntimeConfig split: which *store*
    to read is execution policy, while the applied knobs land in
    PipelineConfig and therefore in the manifest hash (a tuned run and a
    default run never share resume state)."""

    tuner_geometry: str = "default"
    """Deployment-geometry label the tuner keys winners under (channel
    count / spacing / record length change the optimum, and none of them
    are visible in PipelineConfig).  Operators name their fiber sections;
    the default label is for single-deployment installs."""
