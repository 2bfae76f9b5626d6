"""Pipelined chunk executor: prefetch + retry/backoff + quarantine + spans
(a copy of ``das_diff_veh_tpu/runtime/executor.py``; only ``consult_tuner``
differs, since the port has no tuner yet).

One generic loop used by every batch workflow: a sequence of ``ChunkTask``s
(host-side ``load`` thunks) is streamed through a ``PrefetchLoader`` while
the main thread runs ``compute`` (device work) and ``accumulate`` (ordered
reduction) per chunk.  Failures are isolated per chunk: the failing stage is
retried with linear backoff up to ``RuntimeConfig.max_retries`` times, and a
chunk that still fails lands on the quarantine list — costing one chunk, not
the run.

Accumulation happens on the main thread in task-submission order, so results
are bit-identical to the serial loop regardless of prefetch depth.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

from das_diff_veh_tpu_torch.obs.flight import FlightRecorder
from das_diff_veh_tpu_torch.obs.registry import MetricsRegistry, default_registry
from das_diff_veh_tpu_torch.resilience import faults
from das_diff_veh_tpu_torch.runtime.config import RuntimeConfig
from das_diff_veh_tpu_torch.runtime.prefetch import PrefetchLoader
from das_diff_veh_tpu_torch.runtime.tracing import NullTracer

log = logging.getLogger("das_diff_veh_tpu_torch.runtime")


class _NullObs:
    """No-op stand-in for the metric families and the flight recorder when
    ``ObsConfig.enabled`` is False (the bare side of an instrumentation
    A/B): the hot loop stays branch-free while paying literally nothing."""

    def labels(self, **kv):
        return self

    def inc(self, by: float = 1.0) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def record(self, kind: str, **fields) -> None:
        pass

    def dump(self, reason: str, **context) -> None:
        return None


_NULL_OBS = _NullObs()


@dataclass
class ChunkTask:
    """One unit of work: a manifest key plus a host-side load thunk."""

    index: int
    key: str
    load: Callable[[], Any]


def consult_tuner(cfg, runtime_cfg: RuntimeConfig,
                  registry: Optional[MetricsRegistry] = None):
    """Apply persisted tuner winners to ``cfg`` per the runtime's policy.

    Returns ``(cfg, None)`` untouched when ``RuntimeConfig.tuner_store`` is
    unset.  The port has no tuner yet (ROADMAP item 13), so a set store
    raises ``NotImplementedError`` instead of running default knobs under a
    configuration that asked for tuned ones.
    """
    if runtime_cfg.tuner_store is None:
        return cfg, None
    raise NotImplementedError(
        f"RuntimeConfig.tuner_store={runtime_cfg.tuner_store!r}: the tuner "
        f"(tune/) is not ported yet (ROADMAP item 13)")


@dataclass
class QuarantineRecord:
    key: str
    stage: str          # "load" or "compute"
    error: str
    retries: int


@dataclass
class ExecStats:
    n_done: int = 0
    n_retries: int = 0
    quarantined: List[QuarantineRecord] = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def chunks_per_s(self) -> float:
        return self.n_done / self.wall_s if self.wall_s > 0 else 0.0


def _retrying(fn: Callable[[], Any], stage: str, key: str, cfg: RuntimeConfig,
              tracer, stats: ExecStats, prior_error: Optional[Exception] = None,
              on_failure: Optional[Callable] = None):
    """Run ``fn`` with up to max_retries extra attempts; returns
    (value, error, n_retries_used).  ``prior_error`` marks an attempt that
    already failed elsewhere (the prefetch thread), so every call here is a
    counted, backed-off retry.  ``on_failure(stage, key, error, attempt)``
    fires once per failed attempt *before* the next retry — the hook the
    degradation ladder rides (demote the fancy path so the retry runs the
    fallback)."""
    err: Optional[Exception] = prior_error
    if err is not None and on_failure is not None:
        on_failure(stage, key, err, 0)
    first = 1 if prior_error is not None else 0
    for attempt in range(first, cfg.max_retries + 1):
        if attempt:
            stats.n_retries += 1
            tracer.instant("retry", stage=stage, key=key, attempt=attempt)
            time.sleep(cfg.retry_backoff_s * attempt)
            log.warning("%s: retrying %s (attempt %d/%d): %s", key, stage,
                        attempt, cfg.max_retries, err)
        try:
            return fn(), None, attempt
        except Exception as e:
            err = e
            if on_failure is not None:
                on_failure(stage, key, e, attempt)
    return None, err, cfg.max_retries


def run_pipelined(tasks: Sequence[ChunkTask],
                  compute: Callable[[Any], Any],
                  accumulate: Callable[[ChunkTask, Any], None],
                  cfg: Optional[RuntimeConfig] = None,
                  tracer=None,
                  on_quarantine: Optional[Callable[[QuarantineRecord], None]] = None,
                  registry: Optional[MetricsRegistry] = None,
                  flight: Optional[FlightRecorder] = None,
                  on_stage_failure: Optional[Callable] = None,
                  ) -> ExecStats:
    """Execute every task; never raises for a per-chunk failure.

    ``compute`` runs device work for one loaded value; ``accumulate`` folds
    its result into caller state (called in task order).  ``on_quarantine``
    fires once per permanently-failed chunk (manifest bookkeeping);
    ``on_stage_failure(stage, key, error, attempt)`` once per failed
    attempt before its retry (the degradation ladder's hook — demote a
    flaky code path so the retry takes the fallback).

    Chunk progress, retries, quarantines, per-chunk wall time, and the live
    prefetch queue depth register as ``das_runtime_*`` families into
    ``registry`` (default: the process registry, so a serve front in the
    same process scrapes them); per-chunk records land in ``flight`` and a
    quarantine dumps the ring (the post-mortem artifact).
    """
    cfg = cfg or RuntimeConfig()
    tracer = tracer or NullTracer()
    # an explicit registry/flight is intent enough to instrument; otherwise
    # ObsConfig.enabled=False (an A/B's bare side) skips everything
    obs_on = cfg.obs.enabled or registry is not None or flight is not None
    depth_gauge = None
    if obs_on:
        reg = registry if registry is not None else default_registry()
        flight = flight if flight is not None else FlightRecorder(
            capacity=cfg.obs.flight_capacity, out_dir=cfg.obs.flight_dir,
            name="runtime_flight")
        c_chunks = reg.counter("das_runtime_chunks_total",
                               "chunks by terminal status", labels=("status",))
        c_retries = reg.counter("das_runtime_retries_total",
                                "per-stage retry attempts", labels=("stage",))
        h_chunk = reg.histogram("das_runtime_chunk_seconds",
                                "wall seconds per completed chunk")
    else:
        flight = _NULL_OBS
        c_chunks = c_retries = h_chunk = _NULL_OBS
    stats = ExecStats()
    loader = PrefetchLoader([t.load for t in tasks], depth=cfg.prefetch_depth)
    if obs_on:
        depth_gauge = reg.gauge("das_runtime_prefetch_depth",
                                "chunks staged ahead by the loader")
        depth_gauge.set_fn(loader.qsize)
    t_start = time.perf_counter()
    try:
        pending = iter(loader)
        while True:
            with tracer.span("input_wait"):
                nxt = next(pending, None)
            if nxt is None:
                break
            idx, value, err = nxt
            task = tasks[idx]
            t_chunk0 = time.perf_counter()
            retries = 0
            if err is not None:
                # the prefetched attempt was attempt 0; retry inline from 1
                log.warning("%s: load failed: %s", task.key, err)
                value, err, retries = _retrying(task.load, "load", task.key,
                                                cfg, tracer, stats,
                                                prior_error=err,
                                                on_failure=on_stage_failure)
                if retries:
                    c_retries.labels(stage="load").inc(retries)
            if err is not None:
                rec = QuarantineRecord(task.key, "load", f"{type(err).__name__}: {err}",
                                       retries)
                stats.quarantined.append(rec)
                log.error("%s: quarantined after load failure: %s", task.key, rec.error)
                c_chunks.labels(status="quarantined").inc()
                flight.record("chunk", key=task.key, stage="load",
                              error=rec.error, retries=retries)
                flight.dump("quarantine", key=task.key, stage="load")
                if on_quarantine:
                    on_quarantine(rec)
                continue

            def _compute(v=value):
                # chaos sites: slow-chunk latency + compute dispatch failure
                # (no-ops unless a fault injector is installed)
                faults.fire("runtime.slow", task.key)
                faults.fire("runtime.compute", task.key)
                with tracer.span("compute", key=task.key):
                    return compute(v)

            result, err, retries = _retrying(_compute, "compute", task.key,
                                             cfg, tracer, stats,
                                             on_failure=on_stage_failure)
            if retries:
                c_retries.labels(stage="compute").inc(retries)
            if err is not None:
                rec = QuarantineRecord(task.key, "compute",
                                       f"{type(err).__name__}: {err}", retries)
                stats.quarantined.append(rec)
                log.error("%s: quarantined after compute failure: %s",
                          task.key, rec.error)
                c_chunks.labels(status="quarantined").inc()
                flight.record("chunk", key=task.key, stage="compute",
                              error=rec.error, retries=retries)
                flight.dump("quarantine", key=task.key, stage="compute")
                if on_quarantine:
                    on_quarantine(rec)
                continue

            with tracer.span("accumulate", key=task.key):
                accumulate(task, result)
            stats.n_done += 1
            dt_chunk = time.perf_counter() - t_chunk0
            c_chunks.labels(status="done").inc()
            h_chunk.observe(dt_chunk)
            flight.record("chunk", key=task.key, retries=retries,
                          wall_s=round(dt_chunk, 4))
            tracer.counter("chunks", done=stats.n_done,
                           quarantined=len(stats.quarantined))
    finally:
        loader.close()
        if depth_gauge is not None:
            # replace the loader-bound callback with a plain 0 so the gauge
            # (process-lifetime) stops pinning the loader and any staged
            # sections its queue still holds after an aborted run
            depth_gauge.set(0.0)
    stats.wall_s = time.perf_counter() - t_start
    return stats
