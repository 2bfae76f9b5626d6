"""Structured span tracing in Chrome trace event format, one event per line
(a copy of ``das_diff_veh_tpu/runtime/tracing.py``, same event format).

The runtime emits complete ("ph": "X") duration events for every pipeline
stage (read / preprocess / compute / accumulate) plus a counter ("ph": "C")
event of the running vehicle total, from both the main thread and the
prefetch loader thread.  The file is line-delimited JSON so a killed run
still leaves every completed event on disk; ``load_trace`` re-wraps the
lines into the JSON array form that ``chrome://tracing`` and Perfetto
ingest (both viewers also accept the raw line-delimited file directly — the
Chrome trace parser tolerates missing array brackets).

Timestamps are microseconds since the writer was opened (``perf_counter``
based, so spans from different threads are mutually ordered).

A tracer whose ``device_timeline`` is true also takes the card's own spans:
:class:`DeviceTimeline` records CUDA events round blocks of device work,
converts them onto the tracer's clock, and hands them to ``tracer.device``,
which writes them on a track of their own ("device", ``cat: "device"``)
under the host spans.  A caller opens a unit (``timeline.unit(name,
**args)``) round a call; the code that enqueues the device work inside it
wraps each block in :func:`device_work`, so that the host work between the
blocks (hashing a program key, building a result) stays out of the device
spans: an event recorded on an idle stream takes the time it is recorded,
not the time the device starts the next kernel.  A unit whose device work
interleaves several stages (the ambient day stack's cross-spectra and finish,
chunk after chunk) names each block (``device_work(name)``): the block's
span takes that name in place of the unit's, and all of them are emitted
when the unit ends, with one wait for the card.  A unit may span several
cards (the day stack sharded over cards): a block names the card it runs on
(``device_work(name, device=card, **args)``), its marks go on that card's
current stream and are tied to a clock anchor of that card, and its own
``args`` (the stack's ``card``) join the unit's.  Code that cannot take span
arguments from its caller (a serving factory's program) reads them from
:func:`span_args`, set by the caller with :func:`with_span_args`.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Iterator, List, Optional

import torch

_REQUIRED_KEYS = {"name", "ph", "ts", "pid", "tid"}
DEVICE_TID = 1          # the device track's tid: no thread's ident is 1

_local = threading.local()


class NullTracer:
    """No-op tracer with the TraceWriter API; used when tracing is off."""

    path: Optional[str] = None
    device_timeline = False     # whether the program records device spans

    @contextmanager
    def span(self, name: str, cat: str = "runtime", **args) -> Iterator[None]:
        yield

    def now_us(self) -> float:
        return 0.0

    def complete(self, name: str, start_us: float, cat: str = "runtime",
                 **args) -> None:
        pass

    def counter(self, name: str, **values) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass

    def device(self, name: str, start_us: float, end_us: float, **args) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class TraceWriter(NullTracer):
    """Thread-safe Chrome-trace JSONL writer.

    ``flush_interval_s`` controls crash durability vs syscall cost: 0 (the
    default) flushes after every event line, so a killed run keeps every
    completed span; > 0 batches writes in the stdio buffer and flushes at
    most once per interval (``ObsConfig.trace_flush_interval_s`` — tight
    per-chunk loops stop paying one ``write`` syscall per span, an unclean
    kill can lose up to one interval's events).  ``close`` always flushes.
    """

    device_timeline = True

    def __init__(self, path: str, process_name: str = "das_diff_veh_tpu_torch",
                 flush_interval_s: float = 0.0):
        self.path = path
        self.flush_interval_s = float(flush_interval_s)
        self._f = open(path, "w")
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._last_flush = time.perf_counter()
        self._named_tids: set = set()
        self._emit({"name": "process_name", "ph": "M", "ts": 0, "pid": 1,
                    "tid": 0, "args": {"name": process_name}})

    # -- internals -----------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self) -> int:
        t = threading.current_thread()
        tid = t.ident or 0
        if tid not in self._named_tids:
            self._named_tids.add(tid)
            self._emit({"name": "thread_name", "ph": "M", "ts": 0, "pid": 1,
                        "tid": tid, "args": {"name": t.name}})
        return tid

    def _emit(self, event: dict) -> None:
        line = json.dumps(event)
        with self._lock:
            if not self._f.closed:
                self._f.write(line + "\n")
                if self.flush_interval_s <= 0.0:
                    self._f.flush()
                else:
                    now = time.perf_counter()
                    if now - self._last_flush >= self.flush_interval_s:
                        self._f.flush()
                        self._last_flush = now

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._last_flush = time.perf_counter()

    # -- public API ----------------------------------------------------------
    def now_us(self) -> float:
        """Current trace-clock timestamp; pair with :meth:`complete` for
        spans whose start and end happen on different threads (the serving
        engine's queue-wait span starts in ``submit`` and ends in the
        dispatcher)."""
        return self._now_us()

    def complete(self, name: str, start_us: float, cat: str = "runtime",
                 **args) -> None:
        """Emit one complete ("X") event from an explicit start timestamp
        (a value previously returned by :meth:`now_us`) to now."""
        self._emit({"name": name, "cat": cat, "ph": "X",
                    "ts": round(start_us, 1),
                    "dur": round(max(self._now_us() - start_us, 0.0), 1),
                    "pid": 1, "tid": self._tid(), "args": args})

    @contextmanager
    def span(self, name: str, cat: str = "runtime", **args) -> Iterator[None]:
        """Emit one complete ("X") event covering the with-block."""
        tid = self._tid()
        t0 = self._now_us()
        try:
            yield
        finally:
            self._emit({"name": name, "cat": cat, "ph": "X", "ts": round(t0, 1),
                        "dur": round(self._now_us() - t0, 1), "pid": 1,
                        "tid": tid, "args": args})

    def counter(self, name: str, **values) -> None:
        self._emit({"name": name, "ph": "C", "ts": round(self._now_us(), 1),
                    "pid": 1, "tid": self._tid(), "args": values})

    def instant(self, name: str, **args) -> None:
        self._emit({"name": name, "ph": "i", "s": "g",
                    "ts": round(self._now_us(), 1), "pid": 1,
                    "tid": self._tid(), "args": args})

    def device(self, name: str, start_us: float, end_us: float, **args) -> None:
        """Emit one complete ("X") event of device work, ``cat: "device"``,
        from ``start_us`` to ``end_us`` on the trace clock, on the "device"
        track."""
        if DEVICE_TID not in self._named_tids:
            self._named_tids.add(DEVICE_TID)
            self._emit({"name": "thread_name", "ph": "M", "ts": 0, "pid": 1,
                        "tid": DEVICE_TID, "args": {"name": "device"}})
        self._emit({"name": name, "cat": "device", "ph": "X",
                    "ts": round(start_us, 1),
                    "dur": round(max(end_us - start_us, 0.0), 1),
                    "pid": 1, "tid": DEVICE_TID, "args": args})

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


@contextmanager
def with_span_args(**args) -> Iterator[None]:
    """Within the block, :func:`span_args` on this thread returns ``args``
    (the serving engine sets a request's ``rid`` round its program)."""
    prev = getattr(_local, "args", {})
    _local.args = {**prev, **args}
    try:
        yield
    finally:
        _local.args = prev


def span_args() -> dict:
    """The span arguments :func:`with_span_args` set on this thread."""
    return getattr(_local, "args", {})


def _on_card(device: Optional[torch.device]) -> bool:
    return device is not None and device.type == "cuda"


class DeviceTimeline:
    """The card's spans on a tracer's clock, from CUDA events.

    ``mark(stream)`` records an event on ``stream`` (default: the current
    stream); ``emit(name, m0, m1, **args)`` hands the device time between
    two marks to ``tracer.device`` once the second has completed (it waits
    for it).  The clocks are tied once, on the first mark: an anchor event is
    recorded and synchronised, and the tracer's clock read; an event then
    sits at the anchor's host time plus its elapsed time from the anchor.

    It records only where ``tracer.device_timeline`` is true (a tracer
    without the attribute counts as false; read at each mark, so a tracer
    may turn it off part way) and ``device`` is a CUDA device; otherwise,
    and inside a CUDA graph capture, ``mark`` returns None and creates no
    event, and ``emit`` of a None mark does nothing.  Marks may come from
    several threads.  ``device`` is the card a mark goes on unless the
    caller names another (``mark(device=...)``, :func:`device_work`): each
    card's clock is tied once, by an anchor of its own, since CUDA times
    two events only on one card.
    """

    def __init__(self, tracer, device):
        self.tracer = tracer
        self.device = None if device is None else torch.device(device)
        self._card = _on_card(self.device)
        self._anchors: dict = {}        # card -> (event, tracer microseconds)
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self._card and bool(getattr(self.tracer, "device_timeline", False))

    def _anchored(self, stream, device) -> None:
        with self._lock:
            if device not in self._anchors:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(stream)
                ev.synchronize()
                self._anchors[device] = (ev, self.tracer.now_us())

    def mark(self, stream=None, device=None):
        """An event recorded on ``stream`` now (default: the current stream
        of ``device``, by default the timeline's card), or None (see the
        class)."""
        if not self.active:
            return None
        if torch.cuda.is_current_stream_capturing():
            return None
        device = self.device if device is None else torch.device(device)
        if stream is None:
            stream = torch.cuda.current_stream(device)
        if device not in self._anchors:
            self._anchored(stream, device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def to_us(self, event, device=None) -> float:
        """A completed event of ``device`` (default: the timeline's card)
        on the tracer's clock."""
        anchor, host_us = self._anchors[self.device if device is None else torch.device(device)]
        return host_us + anchor.elapsed_time(event) * 1e3

    def emit(self, name: str, m0, m1, device=None, **args) -> None:
        """One device span from mark ``m0`` to mark ``m1``, both of
        ``device`` (default: the timeline's card)."""
        if m0 is None or m1 is None:
            return
        if not m1.query():
            # only when it must: waiting gives up the interpreter lock, which
            # a busy host (the engine's senders) is slow to hand back
            m1.synchronize()
        self.tracer.device(name, self.to_us(m0, device), self.to_us(m1, device), **args)

    @contextmanager
    def unit(self, name: str, **args) -> Iterator[None]:
        """One unit of work on this thread: each :func:`device_work` block
        inside it becomes a device span ``name`` (or the block's own name)
        with ``args``, emitted when the unit ends (after its last block has
        completed; nothing is emitted if the unit raises)."""
        if not self.active:
            yield
            return
        prev = getattr(_local, "unit", None)
        blocks: list = []
        _local.unit = (self, blocks)
        try:
            yield
        finally:
            _local.unit = prev
        for m0, m1, block, device, extra in blocks:
            self.emit(block or name, m0, m1, device, **args, **extra)

    def offset_us(self, stream=None) -> Optional[float]:
        """An event recorded and completed now, on the tracer's clock, less
        the tracer's clock read just after: how far the conversion has
        drifted since the anchor (None where inactive)."""
        m = self.mark(stream)
        if m is None:
            return None
        m.synchronize()
        now = self.tracer.now_us()
        return self.to_us(m) - now


@contextmanager
def device_work(name: Optional[str] = None, device=None, **args) -> Iterator[None]:
    """Marks on the current stream before and after a block of device work,
    for the unit open on this thread; no unit, no event.  ``name``: the
    block's span name, in place of the unit's; ``device``: the card it runs
    on (default: the unit's timeline's), whose current stream takes the
    marks; ``args`` join the unit's on the block's span.  Put it next to the
    enqueue, with no host work inside that leaves the device waiting, and
    end it where the work is enqueued (or, where the block waits for the
    device, once it has)."""
    unit = getattr(_local, "unit", None)
    if unit is None:
        yield
        return
    timeline, blocks = unit
    m0 = timeline.mark(device=device)
    yield
    blocks.append((m0, timeline.mark(device=device), name, device, args))


def make_tracer(path: Optional[str],
                flush_interval_s: float = 0.0) -> NullTracer:
    return (TraceWriter(path, flush_interval_s=flush_interval_s)
            if path else NullTracer())


def load_trace(path: str) -> List[dict]:
    """Parse + validate a trace file; returns the event list.

    Raises ValueError on any line that is not a Chrome trace event (valid
    JSON object, required keys, dur on complete events), so tests can assert
    format validity with one call.
    """
    events = []
    with open(path) as f:
        for n, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{n}: not valid JSON: {e}") from e
            if not isinstance(ev, dict) or not _REQUIRED_KEYS <= set(ev):
                raise ValueError(f"{path}:{n}: missing Chrome trace keys "
                                 f"{_REQUIRED_KEYS - set(ev)}")
            if ev["ph"] == "X" and "dur" not in ev:
                raise ValueError(f"{path}:{n}: complete event without dur")
            events.append(ev)
    return events
