"""Batch workflows as thin callers of the pipelined execution runtime.

The port of ``das_diff_veh_tpu/pipeline/workflow.py``.  Reference
counterparts: ImagingWorkflowOneDirectory.imaging
(apis/imaging_workflow.py:23-111 — running average, periodic intermediate
snapshots) and Imaging_for_multiple_date_range (:132-203 — date folder loop,
resume by output existence).

A background loader reads, preprocesses and stages the next chunks onto the
card while the card computes the current one; per-chunk failures are
retried then quarantined instead of aborting the date; resume is exact
(config-hash-keyed manifest + partial-accumulator state, restart mid-date);
every stage emits Chrome-trace spans.  Accumulation stays on the main thread
in sorted-file order, so results are bit-identical to the serial loop at any
prefetch depth.

The entry points run on the card unless the caller passes ``device="cpu"``.
The device is resolved once, before any chunk is read: without a card the
run raises instead of quarantining every chunk.

**Staging onto the card** (``RuntimeConfig.device_put``).  In the loader
thread the host waterfall is cast to float32, put in pinned memory and
copied to the card with ``non_blocking=True`` on a side stream, into a
buffer allocated on that stream.  The loader then waits for its own copy
(``side.synchronize()``, which blocks only the loader), so the data has
landed before the compute thread sees the section.  The buffer belongs to
the side stream's pool; the compute thread marks it with ``record_stream``
on its own stream, so the caching allocator does not hand the block to a
later staging copy while compute kernels that read it are still queued.  On
the CPU the section keeps the reader's dtype.

**The fused chunk** (``cfg.chunk_pipeline="fused"``) captures its first
chunk of each geometry in the compute thread while the loader may be staging
the next one; the capture is thread-local (``pipeline.fused``), so the
loader's allocations, pinned copies and stream waits cannot break it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import List, Optional
from zipfile import BadZipFile as zipfile_BadZipFile

import numpy as np
import torch

from das_diff_veh_tpu_torch.config import PipelineConfig
from das_diff_veh_tpu_torch.core.section import DasSection
from das_diff_veh_tpu_torch.device import resolve_device
from das_diff_veh_tpu_torch.io.readers import DirectoryDataset
from das_diff_veh_tpu_torch.obs import (FlightRecorder, MetricsSink, default_registry,
                                        register_memory_gauges)
from das_diff_veh_tpu_torch.pipeline.timelapse import process_chunk
from das_diff_veh_tpu_torch.resilience.health import PoisonedChunkError, screen_section
from das_diff_veh_tpu_torch.runtime import (ChunkTask, RunManifest, RuntimeConfig,
                                            config_hash, consult_tuner, make_tracer,
                                            run_pipelined)

log = logging.getLogger("das_diff_veh_tpu_torch.workflow")


def date_range(start_date: str, end_date: str, fmt: str = "%Y%m%d") -> List[str]:
    """Inclusive date-string list (reference get_date_string_list,
    modules/utils.py:272-287)."""
    a = datetime.strptime(start_date, fmt)
    b = datetime.strptime(end_date, fmt)
    out = []
    while a <= b:
        out.append(a.strftime(fmt))
        a += timedelta(days=1)
    return out


@dataclass
class DirectoryResult:
    avg_image: Optional[np.ndarray] = None   # sum of per-chunk averages (nvel, nfreq)
    n_vehicles: int = 0                      # isolated vehicles accumulated
    n_chunks: int = 0                        # chunks that contributed windows
    wall_s: float = 0.0
    checkpoints: list = field(default_factory=list)
    quarantined: list = field(default_factory=list)  # QuarantineRecord per bad chunk
    n_retries: int = 0
    n_resumed: int = 0                       # chunks restored from the manifest
    chunks_per_s: float = 0.0                # processed this run (excl. resumed)
    vehicles_per_s: float = 0.0
    complete: bool = True                    # every file settled (not truncated)
    n_degraded: int = 0                      # chunks that ran with health-masked channels
    resumed_quarantined: list = field(default_factory=list)
    """Keys the manifest already held as quarantined at start — known-bad
    chunks this run skipped without re-failing them (the restart contract;
    RuntimeConfig.retry_quarantined=True requeues them instead)."""
    n_requeued: int = 0                      # quarantine records cleared for retry


def _manifest_path(out_dir: str, date: str) -> str:
    return os.path.join(out_dir, f"{date}_manifest.json")


def _state_path(out_dir: str, date: str) -> str:
    return os.path.join(out_dir, f"{date}_state.npz")


def _dataset_fingerprint(dataset) -> dict:
    """Dataset knobs that change output values (hashed into the manifest)."""
    return {k: getattr(dataset, k, None)
            for k in ("ch1", "ch2", "smoothing", "sg_window", "sg_order",
                      "rescale_after", "rescale_value")}


def _run_config_hash(cfg: PipelineConfig, method: str, x_is_channels: bool,
                     dataset) -> str:
    return config_hash(cfg, method, x_is_channels, _dataset_fingerprint(dataset))


def _save_state(out_dir: str, date: str, chash: str,
                acc: Optional[np.ndarray], done: dict) -> None:
    """Atomically checkpoint the partial accumulator + done-chunk set.

    This file is the single source of truth for which chunks the
    accumulator already contains (the JSON manifest is reconciled from it
    on resume), so a crash between the two writes can never double-count or
    drop a chunk: the worst case is re-running work the manifest alone
    would have remembered.
    """
    path = _state_path(out_dir, date)
    os.makedirs(out_dir, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, config_hash=np.str_(chash),
             avg_image=(acc if acc is not None else np.zeros(0)),
             keys=np.array(list(done), dtype=np.str_),
             n_windows=np.array(list(done.values()), dtype=np.int64))
    os.replace(tmp, path)


def _load_state(out_dir: str, date: str, chash: str):
    """Returns (acc, done_dict) or None when absent/stale/other-config."""
    path = _state_path(out_dir, date)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as f:
            if str(f["config_hash"]) != chash:
                return None
            acc = np.asarray(f["avg_image"])
            done = {str(k): int(n) for k, n in zip(f["keys"], f["n_windows"])}
    except (KeyError, OSError, ValueError, zipfile_BadZipFile):
        return None
    return (acc if acc.size else None), done


def _not_ported(obs_cfg) -> None:
    """Refuse the observability options whose machinery is ROADMAP item 13."""
    if obs_cfg.profile_dir:
        raise NotImplementedError("ObsConfig.profile_dir: the profiler window is not "
                                  "ported yet (ROADMAP item 13)")
    if obs_cfg.hbm_sample_interval_s > 0:
        raise NotImplementedError("ObsConfig.hbm_sample_interval_s > 0: the device "
                                  "memory sampler is not ported yet (ROADMAP item 13)")


def stage_section(sec: DasSection, dev: torch.device, stream) -> DasSection:
    """The section's data on ``dev``: on the card as float32, copied from
    pinned memory on ``stream``, which this call waits for (see the module
    docstring); on the CPU unchanged."""
    if dev.type != "cuda":
        return sec.to(dev)
    host = sec.data.to(torch.float32).pin_memory()
    with torch.cuda.stream(stream):
        data = torch.empty(host.shape, dtype=torch.float32, device=dev)
        data.copy_(host, non_blocking=True)
    stream.synchronize()
    return DasSection(data, sec.x, sec.t)


def pull_count_and_image(n_windows, image: torch.Tensor):
    """``(int, numpy image)`` in one copy to the host, whichever chunk path
    ran: the fused chunk's 0-d ``n_windows`` rides in front of the image (a
    count below 2**24 is exact in float32); the staged chunk's is already an
    int.  JAX ``workflow.py:310-320`` pulls both in one ``device_get``."""
    if not torch.is_tensor(n_windows):
        return int(n_windows), image.cpu().numpy()
    both = torch.cat([n_windows.reshape(1).to(image.dtype), image.reshape(-1)]).cpu()
    return int(both[0]), both[1:].reshape(image.shape).numpy()


def run_directory(dataset: DirectoryDataset, cfg: Optional[PipelineConfig] = None,
                  method: str = "xcorr", x_is_channels: bool = True,
                  out_dir: Optional[str] = None, n_min_save: float = 30.0,
                  max_chunks: Optional[int] = None,
                  runtime: Optional[RuntimeConfig] = None,
                  tracer=None, compute_fn=None, device=None) -> DirectoryResult:
    """Process every time-window file of one date folder through the
    pipelined runtime on ``device`` (``None`` = the card; raises without one
    before any file is read).  Chunks with zero isolated vehicles are
    skipped, otherwise the chunk's average image is *summed* into the
    accumulator (the reference's ``avg_image += images.avg_image``,
    imaging_workflow.py:67 — a sum of chunk averages, not a vehicle-weighted
    mean), a host numpy sum in sorted file order.  The running sum is
    snapshotted to ``out_dir`` every ``n_min_save`` data-minutes worth of
    chunks; with ``out_dir`` set, a resume manifest + per-chunk state
    checkpoint is maintained so an interrupted run restarts at the first
    unprocessed chunk.

    ``compute_fn`` swaps the per-chunk computation (default: the full
    ``process_chunk`` imaging pipeline on ``device``) for any callable
    ``section -> (n_windows, image | None)``.  With ``cfg.health.enabled``
    the input-health sentinel screens every chunk first on its device
    (custom compute fns receive the sanitized section; a third
    ``ChannelHealth`` return element, as the default path produces, is
    surfaced the same way) and chunks that complete with masked channels
    are counted/flight-recorded as degraded.

    ``runtime.obs.xla_events`` installs nothing here (the compile-event
    counters are ROADMAP item 13; the knob changes no output bit);
    ``profile_dir`` and ``hbm_sample_interval_s > 0`` raise
    ``NotImplementedError``, as does ``runtime.tuner_store``.
    """
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else PipelineConfig()
    runtime = runtime if runtime is not None else RuntimeConfig()
    obs_cfg = runtime.obs
    _not_ported(obs_cfg)
    own_tracer = tracer is None
    tracer = tracer if tracer is not None else make_tracer(
        runtime.trace_path,
        flush_interval_s=obs_cfg.trace_flush_interval_s)
    res = DirectoryResult()
    date = dataset.directory
    t_start = time.perf_counter()
    stage_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    # --- observability: one registry, a flight ring, an optional sink --------
    # Batch runs register into the process-default registry; the JSONL sink
    # is the scrapeless view for offline runs.  ObsConfig.enabled=False
    # turns the whole stack off: every handle below stays None and
    # run_pipelined sees the same knob.
    obs_on = obs_cfg.enabled
    registry = flight = sink = c_degraded = None
    signals_installed = False

    # everything below may raise (a sink open against a bad path, disk-full
    # checkpoints, compute errors escaping the retry budget); the obs stack
    # and the owned tracer must not leak past this run either way
    try:
        if obs_on:
            registry = default_registry()
            flight = FlightRecorder(capacity=obs_cfg.flight_capacity,
                                    out_dir=obs_cfg.flight_dir,
                                    name=f"flight_{date}")
            if obs_cfg.metrics_jsonl:
                sink = MetricsSink(registry, obs_cfg.metrics_jsonl,
                                   obs_cfg.metrics_interval_s)
            register_memory_gauges(registry)
            c_degraded = registry.counter(
                "das_health_degraded_chunks_total",
                "chunks completed with health-masked channels")
            if obs_cfg.flight_dir is not None:
                signals_installed = flight.install_signal_handlers()
        cfg, _tuned = consult_tuner(cfg, runtime, registry=registry)
        # --- manifest: load-or-invalidate, restore partial state ----------------
        chash = _run_config_hash(cfg, method, x_is_channels, dataset)
        if flight is not None:
            flight.record("run", date=date, config_hash=chash, method=method,
                          n_files=len(dataset.files))
        manifest: Optional[RunManifest] = None
        acc: Optional[np.ndarray] = None
        done: dict = {}                      # key -> n_windows, in processed order
        if out_dir:
            manifest = RunManifest.load(_manifest_path(out_dir, date))
            if manifest is not None and manifest.config_hash != chash:
                log.warning("%s: config hash changed (%s -> %s); stale outputs "
                            "invalidated, reprocessing", date,
                            manifest.config_hash, chash)
                manifest = None
            st = _load_state(out_dir, date, chash)
            if manifest is not None and st is not None:
                acc, done = st
            if manifest is None:
                manifest = RunManifest(path=_manifest_path(out_dir, date),
                                       config_hash=chash, date=date)
            # reconcile: the state checkpoint is authoritative for done chunks
            # (quarantine records stay manifest-side; a done entry the state
            # never absorbed is dropped and recomputed).  Health provenance
            # rides along: a resumed degraded chunk keeps its record.
            for k in list(manifest.files):
                if manifest.files[k]["status"] == "done" and k not in done:
                    del manifest.files[k]
            for k, n in done.items():
                prior = manifest.files.get(k) or {}
                manifest.mark_done(k, n, health=prior.get("health"))
            # known-bad chunks: skipped on restart (settled), unless the
            # operator asked for a fresh attempt through the retry ladder
            if runtime.retry_quarantined:
                res.n_requeued = manifest.clear_quarantined()
                if res.n_requeued:
                    log.info("%s: retry_quarantined — %d known-bad chunks "
                             "requeued", date, res.n_requeued)
            res.resumed_quarantined = sorted(manifest.quarantined)
            manifest.complete = False
            manifest.save()
            res.n_resumed = sum(1 for p in dataset.files
                                if manifest.is_settled(os.path.basename(p)))
            if res.n_resumed:
                log.info("%s: resuming — %d/%d chunks already settled "
                         "(%d known-bad skipped)", date, res.n_resumed,
                         len(dataset.files), len(res.resumed_quarantined))
        state = {"n_vehicles": sum(done.values()),
                 "n_chunks": sum(1 for n in done.values() if n > 0)}

        # --- build the remaining work list --------------------------------------
        settled = (manifest.is_settled if manifest is not None
                   else (lambda key: False))
        remaining = [(i, p) for i, p in enumerate(dataset.files)
                     if not settled(os.path.basename(p))]
        truncated = max_chunks is not None and len(remaining) > max_chunks
        if truncated:
            remaining = remaining[:max_chunks]

        split_load = hasattr(dataset, "read") and hasattr(dataset, "preprocess")

        def make_task(i: int, path: str) -> ChunkTask:
            # index = absolute position in dataset.files, so snapshot tags and
            # progress logs stay truthful across resumed runs
            key = os.path.basename(path)

            def load() -> DasSection:
                if split_load:
                    with tracer.span("read", file=key):
                        sec = dataset.read(i)
                    with tracer.span("preprocess", file=key):
                        sec = dataset.preprocess(sec, i)
                else:
                    with tracer.span("read", file=key):
                        sec = dataset[i]
                if runtime.device_put:
                    with tracer.span("device_put", file=key):
                        sec = stage_section(sec, dev, stage_stream)
                return sec

            return ChunkTask(index=i, key=key, load=load)

        tasks = [make_task(i, p) for i, p in remaining]

        # --- snapshot cadence (reference n_min_save, imaging_workflow.py:68-74) --
        try:
            interval_s = dataset.time_interval()
        except ValueError:
            interval_s = n_min_save * 60.0
        n_win_save = max(int(n_min_save * 60.0 / interval_s), 1)

        # --- the three runtime callbacks ----------------------------------------
        def _default_compute(section: DasSection):
            chunk = process_chunk(section, cfg, method=method,
                                  x_is_channels=x_is_channels, device=dev)
            n, img = pull_count_and_image(chunk.n_windows, chunk.disp_image)
            return n, (img if n > 0 else None), chunk.health

        chunk_fn = compute_fn if compute_fn is not None else _default_compute

        # input-health sentinel for CUSTOM compute fns: the default path
        # screens inside process_chunk (so ChunkResult carries the verdict);
        # a caller-supplied compute_fn gets the same screen applied here —
        # either way exactly one screen per chunk, none when disabled.
        screen_custom = compute_fn is not None and cfg.health.enabled

        def compute(section: DasSection):
            tic = time.perf_counter()
            if section.data.is_cuda:
                section.data.record_stream(torch.cuda.current_stream(section.data.device))
            health = None
            if screen_custom:
                section, health = screen_section(section.to(dev), cfg.health,
                                                 tag="runtime")
                if not health.ok(cfg.health):
                    raise PoisonedChunkError(health)
            out = chunk_fn(section)
            n, img = out[0], out[1]
            if len(out) > 2 and out[2] is not None:
                health = out[2]
            return int(n), img, time.perf_counter() - tic, health

        def checkpoint() -> None:
            if out_dir:
                _save_state(out_dir, date, chash, acc, done)  # state first: truth
                manifest.save()

        seq_done = {"n": 0}              # chunks accumulated THIS run

        def accumulate(task: ChunkTask, result) -> None:
            nonlocal acc
            n, img, dt_chunk, health = result
            if n > 0:
                acc = img if acc is None else acc + img
                state["n_vehicles"] += n
                state["n_chunks"] += 1
            degraded = health is not None and health.degraded
            if degraded:
                # the chunk completed with unhealthy channels masked — count
                # it, flight-record it, persist the provenance in the manifest
                res.n_degraded += 1
                if c_degraded is not None:
                    c_degraded.inc()
                if flight is not None:
                    flight.record("health", key=task.key, **health.summary())
                log.warning("chunk %s: degraded — %s", task.key,
                            health.summary())
            done[task.key] = n
            if manifest is not None:
                manifest.mark_done(task.key, n,
                                   health=health.summary() if degraded
                                   else None)
            seq_done["n"] += 1
            log.info("chunk %s (%d/%d): %d windows, %.2fs", task.key,
                     task.index + 1, len(dataset.files), n, dt_chunk)
            tracer.counter("vehicles", total=state["n_vehicles"])
            if seq_done["n"] % runtime.state_every == 0 or \
                    seq_done["n"] == len(tasks):
                checkpoint()
            if out_dir and acc is not None and \
                    (task.index == 0 or (task.index + 1) % n_win_save == 0):
                _save_snapshot(out_dir, date, acc, state["n_vehicles"],
                               tag=f"win{task.index + 1}")
                res.checkpoints.append(task.index + 1)

        def on_quarantine(rec) -> None:
            if manifest is not None:
                manifest.mark_quarantined(rec.key, rec.stage, rec.error,
                                          rec.retries)
            checkpoint()

        def on_stage_failure(stage, key, error, attempt):
            # The degradation ladder (ROADMAP item 5) hooks in here: the JAX
            # workflow demotes the fused gather process-wide after a compute
            # failure on a TPU.  The port demotes nothing until the ladder
            # exists, so a failed kernel shows as a quarantined chunk, never
            # as a quiet switch to another path.
            if stage == "compute" and not isinstance(error, PoisonedChunkError):
                log.warning("%s: compute attempt %d failed: %s", key, attempt, error)

        n_veh0 = state["n_vehicles"]
        stats = run_pipelined(tasks, compute, accumulate, cfg=runtime,
                              tracer=tracer, on_quarantine=on_quarantine,
                              registry=registry, flight=flight,
                              on_stage_failure=on_stage_failure)

        # --- completion + result ---------------------------------------------
        res.avg_image = acc
        res.n_vehicles = state["n_vehicles"]
        res.n_chunks = state["n_chunks"]
        res.quarantined = list(stats.quarantined)
        res.n_retries = stats.n_retries
        res.complete = not truncated
        if manifest is not None:
            res.complete = res.complete and all(
                manifest.is_settled(os.path.basename(p)) for p in dataset.files)
            manifest.complete = res.complete
            checkpoint()
        res.wall_s = time.perf_counter() - t_start
        n_processed = stats.n_done + len(stats.quarantined)
        if stats.wall_s > 0 and n_processed:
            res.chunks_per_s = n_processed / stats.wall_s
            res.vehicles_per_s = (state["n_vehicles"] - n_veh0) / stats.wall_s
        return res
    finally:
        if sink is not None:
            sink.close()            # final snapshot line
        if signals_installed:
            flight.uninstall_signal_handlers()
        if own_tracer:
            tracer.close()


def _save_snapshot(out_dir: str, date: str, avg_image: np.ndarray,
                   n_vehicles: int, tag: str = "final") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{date}_{tag}.npz")
    tmp = path + ".tmp.npz"          # atomic: resume reads this file unguarded
    np.savez(tmp, avg_image=avg_image, n_vehicles=n_vehicles)
    os.replace(tmp, path)
    return path


def run_date_range(root: str, start_date: str, end_date: str,
                   cfg: Optional[PipelineConfig] = None, method: str = "xcorr",
                   out_dir: str = "results", n_min_save: float = 30.0,
                   max_chunks: Optional[int] = None, x_is_channels: bool = True,
                   runtime: Optional[RuntimeConfig] = None, device=None,
                   **dataset_kwargs) -> dict:
    """Run every date folder in [start_date, end_date] through the runtime
    on ``device`` (``None`` = the card; raises without one before any folder
    is read).

    Resume is manifest-driven: a date is skipped only when its manifest says
    the run completed under the *same* config hash (or, for pre-manifest
    outputs, when the final .npz exists) — and skipped dates still report
    their ``n_vehicles`` from the existing final .npz so resumed and fresh
    runs are comparable.  A config change invalidates stale outputs and
    reprocesses; an interrupted date resumes mid-directory.
    """
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else PipelineConfig()
    runtime = runtime if runtime is not None else RuntimeConfig()
    _not_ported(runtime.obs)
    tracer = make_tracer(runtime.trace_path,
                         flush_interval_s=runtime.obs.trace_flush_interval_s)
    summary = {}
    try:
        for date in date_range(start_date, end_date):
            folder = os.path.join(root, date)
            final_path = os.path.join(out_dir, f"{date}_final.npz")
            if not os.path.isdir(folder):
                log.info("%s: no data folder, skipping", date)
                continue
            dataset = DirectoryDataset(directory=date, root=root,
                                       **dataset_kwargs)
            chash = _run_config_hash(cfg, method, x_is_channels, dataset)
            man = RunManifest.load(_manifest_path(out_dir, date))
            man_done = man is not None and man.config_hash == chash and man.complete
            if os.path.exists(final_path) and (man is None or man_done):
                # completed under this config (or a legacy pre-manifest run)
                try:
                    with np.load(final_path) as f:
                        n_veh = int(f["n_vehicles"])
                except (KeyError, OSError, ValueError, zipfile_BadZipFile) as e:
                    log.warning("%s: final output unreadable (%s); "
                                "reprocessing the date", date, e)
                else:
                    log.info("%s: complete output exists, skipping (resume)",
                             date)
                    summary[date] = {"skipped": True, "n_vehicles": n_veh}
                    continue
            res = run_directory(dataset, cfg, method=method, out_dir=out_dir,
                                n_min_save=n_min_save, max_chunks=max_chunks,
                                x_is_channels=x_is_channels, runtime=runtime,
                                tracer=tracer, device=dev)
            if res.complete and res.avg_image is not None:
                _save_snapshot(out_dir, date, res.avg_image, res.n_vehicles)
            summary[date] = {"n_vehicles": res.n_vehicles,
                             "n_chunks": res.n_chunks,
                             "wall_s": round(res.wall_s, 2),
                             "chunks_per_s": round(res.chunks_per_s, 3),
                             "n_quarantined": len(res.quarantined),
                             "n_degraded": res.n_degraded,
                             "n_resumed": res.n_resumed,
                             "complete": res.complete}
            log.info("%s: %s", date, json.dumps(summary[date]))
    finally:
        tracer.close()
    return summary
