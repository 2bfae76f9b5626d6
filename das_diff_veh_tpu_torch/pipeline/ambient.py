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

A stack larger than a card is split over several
(``DayStack(nch, cfg, devices=["cuda:0", ..., "cuda:3"])``, then
``stack_records(records, stack=stack)``): each card holds the stack rows of
a contiguous block of whole source chunks (:attr:`DayStack.shards`), dealt
so that each card has about as much work (:func:`deal_chunks`).  The record
is staged onto the first card, the home card, once, and its spectra made
there once; each other card is sent only the spectra rows its chunks read,
and of those only the whitening band's bins, card to card, and its chunks
wait for them by event.  The cards' chunks are enqueued interleaved, so
that all start at once (``ops.all_pairs.add_banded`` over the shards), and
``add`` returns once every card's last band add is in.  Each pair is
computed as on one card, from the same bits, so the rows are those of the
one-card stack.  One card is one shard of the same path, which sends
nothing card to card.

Records stream through the batch runtime (``runtime.executor.run_pipelined``
with ``runtime.prefetch``): a loader thread reads each SEG-Y file, or takes
the array, and stages it onto the card (``runtime.staging``: streamed
through a ring of pinned slabs on a side stream), while the main thread
adds the record before into the stack; a record that fails to load or
compute is retried, then quarantined.  ``add`` returns once the record's
contribution is in the stack on the card.

Spans, on the tracer of the run: ``ambient_stage`` (loader thread: the
record to the card), and once a record on the main thread
``ambient_spectra`` (one-bit, windows, rfft, whitening enqueued),
``ambient_cross`` (the chunks' cross-spectra and their finish enqueued) and
``ambient_finish`` (the wait until the record's last band is in the stack,
on every card); on a stack over several cards ``ambient_scatter`` between
the first two (the band rows sent to the other cards enqueued; arg
``bytes``, the bytes sent card to card); ``ambient_flush`` for each flush.
Each carries key ``record`` (flush: no key).  The device work of a record
is in device blocks of the same names (one ``ambient_stage`` and one
``ambient_spectra``, an ``ambient_scatter`` block on each card sent to, and
an ``ambient_cross`` and an ``ambient_finish`` block a source chunk, on
the chunk's card, with arg ``card``, the shard's place in
:attr:`DayStack.shards`; named blocks of one unit a record), which a
tracer that keeps the device timeline turns into device spans once the
record is in.  Registry counters: ``das_ambient_records_total`` (records
stacked), ``das_ambient_pairs_total`` (pairs whose cross-spectra were
computed, the receiver bands' slack included) and
``das_ambient_peer_bytes_total`` (bytes sent card to card); the tracer's
counter ``ambient_records`` carries the stack's running total.

Float32 throughout, TF32 off (``device.resolve_device``).
"""

from __future__ import annotations

import functools
import glob
import os
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from das_diff_veh_tpu_torch import kernels
from das_diff_veh_tpu_torch.config import AmbientConfig
from das_diff_veh_tpu_torch.device import device_scope, resolve_device
from das_diff_veh_tpu_torch.io.segy import read_segy
from das_diff_veh_tpu_torch.obs import default_registry
from das_diff_veh_tpu_torch.ops import band_lag_add
from das_diff_veh_tpu_torch.ops.all_pairs import (BandShard, _window_spectra, add_banded,
                                                 band_schedule)
from das_diff_veh_tpu_torch.ops.noise import band_bins, one_bit, whiten_band
from das_diff_veh_tpu_torch.runtime import (ChunkTask, RuntimeConfig, make_tracer,
                                            run_pipelined)
from das_diff_veh_tpu_torch.runtime.staging import Stager
from das_diff_veh_tpu_torch.runtime.tracing import DeviceTimeline, NullTracer, device_work

SEGY_PATTERNS = ("*.sgy", "*.segy", "*.SGY", "*.SEGY")
FLUSH_SLAB = 256        # sources a flush copies at a time: 1.2 GB of the DASH stack


class Shard(NamedTuple):
    """One card's part of a :class:`DayStack`: its stack rows ``first`` to
    ``last``, both kept, on ``card``."""

    card: torch.device
    first: int
    last: int


def chunk_work(nch: int, schedule: list, max_offset: int) -> List[int]:
    """The work of each chunk of ``schedule`` (``ops.all_pairs.band_schedule``):
    its B3 rectangle of source by band rows plus its in-array pairs, which
    the finish adds."""
    def pairs(s0, s1):
        return sum(min(s + max_offset, nch - 1) - max(s - max_offset, 0) + 1
                   for s in range(s0, s1))

    return [(s1 - s0) * (r1 - r0) + pairs(s0, s1) for s0, s1, r0, r1 in schedule]


def deal_chunks(work: Sequence[int], n: int) -> List[range]:
    """``work``'s chunks in ``n`` contiguous, non-empty blocks whose largest
    sum of work is the least it can be (the first such deal)."""
    c = len(work)
    if not 1 <= n <= c:
        raise ValueError(f"{c} source chunks cannot be dealt to {n} cards")
    pre = np.concatenate(([0], np.cumsum(work)))
    # worst[k][i]: the least largest block of the first i chunks in k blocks
    worst = [[float("inf")] * (c + 1) for _ in range(n + 1)]
    cut = [[0] * (c + 1) for _ in range(n + 1)]
    worst[0][0] = 0
    for k in range(1, n + 1):
        for i in range(k, c + 1):
            for j in range(k - 1, i):
                w = max(worst[k - 1][j], pre[i] - pre[j])
                if w < worst[k][i]:
                    worst[k][i], cut[k][i] = w, j
    ends = [c]
    for k in range(n, 0, -1):
        ends.append(cut[k][ends[-1]])
    ends.reverse()
    return [range(a, b) for a, b in zip(ends, ends[1:])]


class _Part:
    """What a :class:`DayStack` keeps for one shard: its card, its chunks,
    its stack rows, and, on a card other than the home card, the spectra
    rows its chunks read (``row0:row1``: its sources and the receivers
    within ``max_offset``), filled each record from the home card; its
    ``ops.all_pairs.BandShard``, what its chunks' launches take, made once."""

    def __init__(self, index: int, card: torch.device, schedule: list, nch: int,
                 max_offset: int, depth: tuple):
        self.index, self.card, self.schedule = index, card, schedule
        self.first, self.last = schedule[0][0], schedule[-1][1] - 1
        self.row0 = max(self.first - max_offset, 0)
        self.row1 = min(self.last + 1 + max_offset, nch)
        self.sum = torch.zeros((self.last + 1 - self.first, *depth), dtype=torch.float32,
                               device=card)
        # the shard's blocks name its card without a reference back to the
        # part, so that a stack let go frees its memory at once, with no cycle
        self.block = functools.partial(_card_block, card, index)
        self.shard = BandShard(self.sum, schedule, self.first, self.row0, self.block)
        self.inbox: Optional[torch.Tensor] = None       # the band bins as sent
        self.side = None                                # the home card's stream to it


def _card_block(card: torch.device, index: int, name: str):
    """The device block ``ambient_<name>`` of the shard ``index`` on ``card``."""
    return device_work(f"ambient_{name}", device=card, card=index)


class DayStack:
    """The linear stack of one day's noise-correlation gathers,
    (nch, 2*max_offset+1, 2*max_lag+1) float32 on ``device`` (``None`` =
    the card), allocated once: ``sum[s, j, max_lag + k]`` holds the sum
    over the records added of the window-mean correlation of source ``s``
    with receiver ``s + j - max_offset`` at lag ``k`` samples (0 for a
    receiver past either end of the array).  Every record must have
    ``nch`` channels and the length of the first.  The finish is chosen
    once: :attr:`finish_band` is the whitening band's bins where the kernel
    of ``ops.band_lag_add`` takes the window, else None (the irfft).

    ``devices``: the cards the stack is split over (module docstring), the
    first of them the home card, which takes the records; a card appears
    once, a CPU device (in tests) any number of times.  :attr:`shards`
    states the split; on one card ``sum`` is the whole stack, on several
    ``sums`` holds each shard's rows."""

    def __init__(self, nch: int, cfg: Optional[AmbientConfig] = None, device=None,
                 devices: Optional[Sequence] = None):
        self.cfg = cfg if cfg is not None else AmbientConfig()
        c = self.cfg
        if 2 * c.max_lag + 1 > c.wlen:
            raise ValueError(f"max_lag={c.max_lag} keeps more than the {c.wlen} lags of a "
                             f"window")
        self.band = band_bins(c.fs, c.wlen, c.band_hz) if c.whiten else None
        self.finish_band = (self.band if self.band is not None and band_lag_add.takes(c.wlen)
                            else None)
        cards = [_card(d) for d in (devices if devices else [device])]
        if devices and device is not None and _card(device) != cards[0]:
            raise ValueError(f"device {device} is not the first of devices {list(devices)}")
        on_card = [d for d in cards if d.type == "cuda"]
        if len(set(on_card)) != len(on_card):
            raise ValueError(f"a card appears more than once in {[str(d) for d in cards]}")
        self.device = cards[0]
        if on_card:
            # the kernels a record launches, built side by side now
            kernels.build_all(("cross_spectra",) if self.finish_band is None
                              else ("cross_spectra", "band_lag_add"))
        self.nch = int(nch)
        self.schedule = band_schedule(self.nch, c.src_chunk, c.max_offset)
        self.pairs_per_record = sum((s1 - s0) * (r1 - r0) for s0, s1, r0, r1 in self.schedule)
        depth = (2 * c.max_offset + 1, 2 * c.max_lag + 1)
        blocks = deal_chunks(chunk_work(self.nch, self.schedule, c.max_offset), len(cards))
        self._parts = [_Part(i, card, band_schedule(self.nch, c.src_chunk, c.max_offset, b),
                             self.nch, c.max_offset, depth)
                       for i, (card, b) in enumerate(zip(cards, blocks))]
        self._shards = [p.shard for p in self._parts]
        self.shards = [Shard(p.card, p.first, p.last) for p in self._parts]
        self.sums = [p.sum for p in self._parts]
        self.peer_bytes_per_record = 0      # known once the first record is in
        self.records = 0
        self.windows = 0
        self.nt: Optional[int] = None
        self.torn = False

    @property
    def sum(self) -> torch.Tensor:
        """The whole stack, on a stack of one card."""
        if len(self._parts) > 1:
            raise AttributeError(f"a stack over {len(self._parts)} cards has no one sum: "
                                 f"each shard's rows are in sums (shards says which)")
        return self._parts[0].sum

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
            timeline: Optional[DeviceTimeline] = None) -> None:
        """Add one (nch, nt) float32 record on the stack's (home) device;
        returns once its contribution is in the stack on every card.
        ``record`` is the spans' key; ``timeline`` the run's device
        timeline."""
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
            if len(self._parts) > 1:
                self._scatter(wf, tracer, args)
            with tracer.span("ambient_cross", **args):
                self.torn = True            # until the whole record is in
                add_banded(wf, self._shards, c.wlen, c.max_offset, c.max_lag, c.src_chunk,
                           band=self.finish_band)
            with tracer.span("ambient_finish", **args):
                for part in self._parts:
                    if part.card.type == "cuda":
                        torch.cuda.current_stream(part.card).synchronize()
                self.torn = False
        self.records += 1
        self.windows += wf.shape[1]
        self.nt = data.shape[1]

    def _bins(self, nf: int) -> tuple:
        """The bins sent card to card: the whitening band's, else all."""
        return self.band if self.band is not None else (0, nf - 1)

    def _scatter(self, wf: torch.Tensor, tracer, args: dict) -> None:
        """Send each other card the spectra rows its chunks read, over the
        bins :meth:`_bins` names, into its spectra buffer (zero outside
        them, as whitening leaves the home card's).  On cards, each copy
        runs on a stream of the home card's kept for the card it goes to,
        once the spectra are made, and that card's own stream waits for it
        by event; no host wait."""
        lo, hi = self._bins(wf.shape[2])
        peers = self._parts[1:]
        shape = (wf.shape[1], hi - lo + 1)
        if peers[0].inbox is None or peers[0].inbox.shape[1:] != shape:
            for p in peers:         # once a stack (again after a clear to another length)
                p.shard.spectra = torch.zeros((p.row1 - p.row0, *wf.shape[1:]),
                                              dtype=wf.dtype, device=p.card)
                p.inbox = torch.empty((p.row1 - p.row0, *shape), dtype=wf.dtype, device=p.card)
                if p.card.type == "cuda" and p.side is None:
                    p.side = torch.cuda.Stream(self.device)
            self.peer_bytes_per_record = sum(p.inbox.numel() * p.inbox.element_size()
                                             for p in peers)
        top = min(p.row0 for p in peers)
        with tracer.span("ambient_scatter", bytes=self.peer_bytes_per_record, **args):
            band = wf[top:, :, lo:hi + 1].contiguous()
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            for p in peers:
                rows = band[p.row0 - top:p.row1 - top]
                if p.side is None:
                    with p.block("scatter"):
                        p.inbox.copy_(rows)
                        p.shard.spectra[:, :, lo:hi + 1] = p.inbox
                    continue
                # the copy runs on the home card's stream kept for this card
                # (PyTorch copies on the source card's current stream), which
                # waits for the spectra; the card's current stream waits for
                # the copy.  ``band``'s memory goes back to the home card's
                # pool when this returns, so it is marked as read on the
                # side stream: the home card's next allocations wait for it.
                p.side.wait_event(ready)
                band.record_stream(p.side)
                torch.cuda.current_stream(p.card).wait_event(ready)
                with torch.cuda.stream(p.side), device_scope(p.card), p.block("scatter"):
                    p.inbox.copy_(rows, non_blocking=True)
                    p.shard.spectra[:, :, lo:hi + 1] = p.inbox

    def flush(self, rows=None, tracer=None) -> np.ndarray:
        """The mean over the records added of the gathers of source ``rows``
        (default: every source), in the order asked, as host float32
        (len(rows), 2*max_offset+1, 2*max_lag+1), each from the card that
        holds it, copied ``FLUSH_SLAB`` sources at a time.  Each record's
        gather is already a mean over its windows, and every record has as
        many, so this is the mean over the windows stacked.  The stack is
        left as it is."""
        if self.torn:
            raise RuntimeError("an earlier record failed part way into this stack: its sum "
                               "is not one of whole records")
        if self.records == 0:
            raise ValueError("no record has been added to this stack")
        rows = np.arange(self.nch) if rows is None else np.asarray(rows, dtype=np.int64)
        if len(rows) and not 0 <= rows.min() <= rows.max() < self.nch:
            raise IndexError(f"rows of this stack are 0..{self.nch - 1}, got {rows.min()} "
                             f"to {rows.max()}")
        tracer = tracer if tracer is not None else NullTracer()
        out = np.empty((len(rows), *self._parts[0].sum.shape[1:]), dtype=np.float32)
        with tracer.span("ambient_flush"):
            for p in self._parts:
                at = np.flatnonzero((rows >= p.first) & (rows <= p.last))
                if not len(at):
                    continue
                n = torch.tensor(float(self.records), dtype=torch.float32, device=p.card)
                for i0 in range(0, len(at), FLUSH_SLAB):
                    sel = at[i0:i0 + FLUSH_SLAB]
                    idx = torch.as_tensor(rows[sel] - p.first, device=p.card)
                    out[sel] = torch.div(p.sum.index_select(0, idx), n).cpu().numpy()
        return out

    def clear(self) -> None:
        """Empty the stack for the next day (its memory is kept)."""
        for p in self._parts:
            p.sum.zero_()
        self.records = self.windows = 0
        self.nt = None
        self.torn = False


def _card(device) -> torch.device:
    """``device`` resolved (``None`` = the card), a card with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


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
    stager = Stager(dev, tracer)
    registry = default_registry() if runtime.obs.enabled else None
    if registry is not None:
        c_records = registry.counter("das_ambient_records_total",
                                     "records added into an ambient-noise day stack")
        c_pairs = registry.counter("das_ambient_pairs_total",
                                   "channel pairs whose cross-spectra the day stack computed")
        c_peer = registry.counter("das_ambient_peer_bytes_total",
                                  "spectra bytes a day stack over several cards sent card "
                                  "to card")
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
                    return base + i, stager.put(host, "ambient_stage", record=base + i)
            return base + i, host

        return ChunkTask(index=i, key=key, load=load)

    def compute(loaded):
        record, data = loaded
        data = stager.claim(data).to(dev)
        if run.stack is None:
            run.stack = DayStack(data.shape[0], cfg, dev)
        run.stack.add(data, record=record, tracer=tracer, timeline=stager.timeline)

    def accumulate(task: ChunkTask, _) -> None:
        run.records += 1
        if registry is not None:
            c_records.inc()
            c_pairs.inc(run.stack.pairs_per_record)
            c_peer.inc(run.stack.peer_bytes_per_record)
        tracer.counter("ambient_records", total=run.stack.records)

    try:
        stats = run_pipelined([make_task(i, r) for i, r in enumerate(records)], compute,
                              accumulate, cfg=runtime, tracer=tracer, registry=registry)
    finally:
        stager.close()
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
