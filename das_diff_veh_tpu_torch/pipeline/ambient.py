"""The ambient-noise day stack of a dense DAS array.

The processing of Bensen et al. (2007, GJI 169:1239-1260) as Zeng et al.
(2017, BSSA 107:603) apply it to DAS: each record is one-bit normalised, cut
into overlapping windows, transformed, whitened over a band
(``ops.noise``), cross-correlated window by window for every pair of
channels within ``AmbientConfig.max_offset`` of each other
(``ops.all_pairs.add_banded``: kernel B3 on the card, its plain version on
the CPU), cut to the lags
within ``max_lag`` of zero, and added into a linear stack that stays on the
card for the day.  Whitened spectra carry their band into the finish, which
then runs over the band alone (``ops.band_lag_add``: a kernel on the card,
its plain version on the CPU); without whitening it is the full irfft.  The
product is one noise-correlation gather per source channel, its
``2*max_offset+1`` nearest receivers by ``2*max_lag+1`` lags: the
virtual-source gathers of near-surface dispersion imaging.

    run = stack_records(records)          # (nch, nt) arrays or SEG-Y paths
    run = stack_directory("day/")         # every *.sgy / *.segy file, sorted
    gathers = run.stack.flush()           # host float32 mean over records

Records stream through the batch runtime (``runtime.executor.run_pipelined``
with ``runtime.prefetch``): a loader thread reads each SEG-Y file, or takes
the array, and stages it onto the card, pinned and copied on a side stream,
while the main thread adds the record before into the stack; a record that
fails to load or compute is retried, then quarantined.  ``add`` returns
once the record's contribution is in the stack on the card.

Spans, on the tracer of the run: ``ambient_stage`` (loader thread: the
record to the card), and once a record on the main thread
``ambient_spectra`` (one-bit, windows, rfft, whitening enqueued),
``ambient_cross`` (the chunks' cross-spectra and their finish enqueued) and
``ambient_finish`` (the wait until the record's last band is in the stack);
``ambient_flush`` for each flush.  Each carries key ``record`` (flush: no
key).  The device work of a record is in device blocks of the same names
(one ``ambient_stage`` and one ``ambient_spectra``, and an ``ambient_cross``
and an ``ambient_finish`` block a source chunk, named blocks of one unit a
record), which a tracer that keeps the device timeline turns into device
spans once the record is in.  Registry
counters: ``das_ambient_records_total`` (records stacked),
``das_ambient_band_finish_records_total`` (those whose finish ran over the
whitening band alone) and ``das_ambient_pairs_total`` (pairs whose
cross-spectra were computed, the receiver bands' slack included); the
tracer's counter ``ambient_records`` carries the stack's running total.

Float32 throughout, TF32 off (``device.resolve_device``).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from das_diff_veh_tpu_torch import kernels
from das_diff_veh_tpu_torch.config import AmbientConfig
from das_diff_veh_tpu_torch.device import resolve_device
from das_diff_veh_tpu_torch.io.segy import read_segy
from das_diff_veh_tpu_torch.obs import default_registry
from das_diff_veh_tpu_torch.ops import band_lag_add
from das_diff_veh_tpu_torch.ops.all_pairs import _window_spectra, add_banded, band_schedule
from das_diff_veh_tpu_torch.ops.noise import band_bins, one_bit, whiten_band
from das_diff_veh_tpu_torch.runtime import (ChunkTask, RuntimeConfig, make_tracer,
                                            run_pipelined)
from das_diff_veh_tpu_torch.runtime.tracing import DeviceTimeline, NullTracer, device_work

SEGY_PATTERNS = ("*.sgy", "*.segy", "*.SGY", "*.SEGY")
FLUSH_SLAB = 256        # sources a flush copies at a time: 1.2 GB of the DASH stack


class DayStack:
    """The linear stack of one day's noise-correlation gathers,
    (nch, 2*max_offset+1, 2*max_lag+1) float32 on ``device`` (``None`` =
    the card), allocated once: ``sum[s, j, max_lag + k]`` holds the sum
    over the records added of the window-mean correlation of source ``s``
    with receiver ``s + j - max_offset`` at lag ``k`` samples (0 for a
    receiver past either end of the array).  Every record must have
    ``nch`` channels and the length of the first."""

    def __init__(self, nch: int, cfg: Optional[AmbientConfig] = None, device=None):
        self.cfg = cfg if cfg is not None else AmbientConfig()
        c = self.cfg
        if 2 * c.max_lag + 1 > c.wlen:
            raise ValueError(f"max_lag={c.max_lag} keeps more than the {c.wlen} lags of a "
                             f"window")
        self.band = band_bins(c.fs, c.wlen, c.band_hz) if c.whiten else None
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            # the kernels a record launches, built side by side now
            banded = self.band is not None and band_lag_add.takes(c.wlen)
            kernels.build_all(("cross_spectra", "band_lag_add") if banded else ("cross_spectra",))
        self.nch = int(nch)
        self.schedule = band_schedule(self.nch, c.src_chunk, c.max_offset)
        self.pairs_per_record = sum((s1 - s0) * (r1 - r0) for s0, s1, r0, r1 in self.schedule)
        self.sum = torch.zeros((self.nch, 2 * c.max_offset + 1, 2 * c.max_lag + 1),
                               dtype=torch.float32, device=self.device)
        self.records = 0
        self.windows = 0
        self.nt: Optional[int] = None
        self.torn = False

    def spectra(self, data: torch.Tensor) -> torch.Tensor:
        """(nch, nwin, wlen//2+1) complex64 window spectra of a record:
        one-bit, windows, rfft and band whitening as the config says."""
        c = self.cfg
        if c.one_bit:
            data = one_bit(data)
        wf = _window_spectra(data, c.wlen, c.overlap_ratio)
        if self.band is not None:
            whiten_band(wf, *self.band)
        return wf

    def add(self, data: torch.Tensor, record=None, tracer=None,
            timeline: Optional[DeviceTimeline] = None) -> bool:
        """Add one (nch, nt) float32 record on the stack's device; returns
        once its contribution is in the stack, with whether its finish ran
        over the whitening band alone.  ``record`` is the spans' key;
        ``timeline`` the run's device timeline."""
        c = self.cfg
        if self.torn:
            raise RuntimeError("an earlier record failed part way into this stack; "
                               "clear() it before adding more")
        if data.dim() != 2 or data.shape[0] != self.nch:
            raise ValueError(f"a record of this stack is ({self.nch}, nt), got "
                             f"{tuple(data.shape)}")
        if self.nt is not None and data.shape[1] != self.nt:
            raise ValueError(f"records of this stack have {self.nt} samples, got "
                             f"{data.shape[1]}")
        if data.shape[1] < c.wlen:
            raise ValueError(f"a record of {data.shape[1]} samples holds no {c.wlen}-sample "
                             f"window")
        if data.device != self.device or data.dtype != torch.float32:
            raise ValueError(f"a record must be float32 on {self.device}, got {data.dtype} "
                             f"on {data.device}")
        tracer = tracer if tracer is not None else NullTracer()
        timeline = timeline if timeline is not None else DeviceTimeline(tracer, None)
        args = {} if record is None else {"record": record}
        with timeline.unit("ambient_record", **args):
            with tracer.span("ambient_spectra", **args), device_work("ambient_spectra"):
                wf = self.spectra(data)
            with tracer.span("ambient_cross", **args):
                self.torn = True            # until the whole record is in
                banded = add_banded(wf, self.sum, c.wlen, c.max_offset, c.max_lag,
                                    c.src_chunk, band=self.band,
                                    block=lambda name: device_work(f"ambient_{name}"))
            with tracer.span("ambient_finish", **args):
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                self.torn = False
        self.records += 1
        self.windows += wf.shape[1]
        self.nt = data.shape[1]
        return bool(banded)

    def flush(self, rows=None, tracer=None) -> np.ndarray:
        """The mean over the records added of the gathers of source ``rows``
        (default: every source), as host float32 (len(rows),
        2*max_offset+1, 2*max_lag+1), copied ``FLUSH_SLAB`` sources at a time.
        Each record's gather is already a mean over its windows, and every
        record has as many, so this is the mean over the windows stacked.
        The stack is left as it is."""
        if self.torn:
            raise RuntimeError("an earlier record failed part way into this stack: its sum "
                               "is not one of whole records")
        if self.records == 0:
            raise ValueError("no record has been added to this stack")
        rows = np.arange(self.nch) if rows is None else np.asarray(rows, dtype=np.int64)
        tracer = tracer if tracer is not None else NullTracer()
        out = np.empty((len(rows), *self.sum.shape[1:]), dtype=np.float32)
        n = torch.tensor(float(self.records), dtype=torch.float32, device=self.device)
        with tracer.span("ambient_flush"):
            for i0 in range(0, len(rows), FLUSH_SLAB):
                idx = torch.as_tensor(rows[i0:i0 + FLUSH_SLAB], device=self.device)
                out[i0:i0 + FLUSH_SLAB] = torch.div(self.sum.index_select(0, idx),
                                                    n).cpu().numpy()
        return out

    def clear(self) -> None:
        """Empty the stack for the next day (its memory is kept)."""
        self.sum.zero_()
        self.records = self.windows = 0
        self.nt = None
        self.torn = False


@dataclass
class AmbientRun:
    """What one :func:`stack_records` call did: the stack (None when no
    record reached it), the records it added, and those it quarantined
    (``runtime.executor.QuarantineRecord``)."""

    stack: Optional[DayStack]
    records: int = 0
    quarantined: list = field(default_factory=list)


def _is_path(item) -> bool:
    return isinstance(item, (str, os.PathLike))


def _read_segy(path, fs: float) -> torch.Tensor:
    """A SEG-Y record read whole, as a host float32 tensor; its sampling
    rate must be ``fs``."""
    data, dt, _ = read_segy(os.fspath(path))
    if abs(1.0 / dt - fs) > 1e-6 * fs:
        raise ValueError(f"{os.fspath(path)} is sampled at {1.0 / dt} Hz, the stack at "
                         f"{fs} Hz")
    return torch.from_numpy(data)


def _stage(host: torch.Tensor, dev: torch.device, stream, timeline: DeviceTimeline,
           **args) -> torch.Tensor:
    """``host`` on ``dev``: on the card pinned and copied on ``stream``,
    which this call waits for (a device block ``ambient_stage`` with
    ``args``); on the CPU as it is."""
    if dev.type != "cuda":
        return host
    pinned = host.pin_memory()
    with timeline.unit("ambient_stage", **args):
        with torch.cuda.stream(stream), device_work():
            data = torch.empty(host.shape, dtype=torch.float32, device=dev)
            data.copy_(pinned, non_blocking=True)
        stream.synchronize()
    return data


def stack_records(records: Sequence, cfg: Optional[AmbientConfig] = None,
                  stack: Optional[DayStack] = None, runtime: Optional[RuntimeConfig] = None,
                  tracer=None, device=None) -> AmbientRun:
    """Add ``records``, each an (nch, nt) array or tensor or the path of a
    SEG-Y file, into ``stack`` (default: a new :class:`DayStack` on
    ``device``, ``None`` = the card, sized by the first record) through the
    pipelined runtime (module docstring).  ``runtime``: prefetch depth,
    retries, the trace file, the registry's counters (``obs.enabled``).
    With a ``stack``, its configuration and device are the run's."""
    if stack is not None and cfg is not None and cfg != stack.cfg:
        raise ValueError("cfg differs from the configuration of the stack given")
    cfg = stack.cfg if stack is not None else (cfg if cfg is not None else AmbientConfig())
    dev = stack.device if stack is not None else resolve_device(device)
    runtime = runtime if runtime is not None else RuntimeConfig()
    own_tracer = tracer is None
    tracer = tracer if tracer is not None else make_tracer(
        runtime.trace_path, flush_interval_s=runtime.obs.trace_flush_interval_s)
    timeline = DeviceTimeline(tracer, dev)
    stage_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    registry = default_registry() if runtime.obs.enabled else None
    if registry is not None:
        c_records = registry.counter("das_ambient_records_total",
                                     "records added into an ambient-noise day stack")
        c_band = registry.counter("das_ambient_band_finish_records_total",
                                  "records whose day-stack finish ran over the whitening "
                                  "band alone")
        c_pairs = registry.counter("das_ambient_pairs_total",
                                   "channel pairs whose cross-spectra the day stack computed")
    run = AmbientRun(stack=stack)
    base = stack.records if stack is not None else 0

    def make_task(i: int, item) -> ChunkTask:
        key = os.path.basename(os.fspath(item)) if _is_path(item) else f"record{base + i}"

        def load():
            if _is_path(item):
                with tracer.span("read", file=key):
                    host = _read_segy(item, cfg.fs)
            else:
                host = torch.as_tensor(item).to(torch.float32)
            if runtime.device_put:
                with tracer.span("ambient_stage", record=base + i):
                    return base + i, _stage(host, dev, stage_stream, timeline,
                                            record=base + i)
            return base + i, host

        return ChunkTask(index=i, key=key, load=load)

    def compute(loaded):
        record, data = loaded
        if data.is_cuda:
            data.record_stream(torch.cuda.current_stream(data.device))
        data = data.to(dev)
        if run.stack is None:
            run.stack = DayStack(data.shape[0], cfg, dev)
        return run.stack.add(data, record=record, tracer=tracer, timeline=timeline)

    def accumulate(task: ChunkTask, banded) -> None:
        run.records += 1
        if registry is not None:
            c_records.inc()
            if banded:
                c_band.inc()
            c_pairs.inc(run.stack.pairs_per_record)
        tracer.counter("ambient_records", total=run.stack.records)

    try:
        stats = run_pipelined([make_task(i, r) for i, r in enumerate(records)], compute,
                              accumulate, cfg=runtime, tracer=tracer, registry=registry)
    finally:
        if own_tracer:
            tracer.close()
    run.quarantined = list(stats.quarantined)
    return run


def stack_directory(directory: str, cfg: Optional[AmbientConfig] = None,
                    patterns: Sequence[str] = SEGY_PATTERNS, **kwargs) -> AmbientRun:
    """:func:`stack_records` over the SEG-Y files of ``directory`` that
    match ``patterns``, in sorted order (a day's 30-s files)."""
    paths = sorted({p for pat in patterns for p in glob.glob(os.path.join(directory, pat))})
    if not paths:
        raise FileNotFoundError(f"no SEG-Y file in {directory} (patterns {list(patterns)})")
    return stack_records(paths, cfg, **kwargs)
