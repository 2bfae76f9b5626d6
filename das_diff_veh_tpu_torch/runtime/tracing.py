"""Structured span tracing in Chrome trace event format, one event per line
(a copy of ``das_diff_veh_tpu/runtime/tracing.py``, same event format).

The runtime emits complete ("ph": "X") duration events for every pipeline
stage (read / preprocess / compute / accumulate) plus counter ("ph": "C")
events for throughput, from both the main thread and the prefetch loader
thread.  The file is line-delimited JSON so a killed run still leaves every
completed event on disk; ``load_trace`` re-wraps the lines into the JSON
array form that ``chrome://tracing`` and Perfetto ingest (both viewers also
accept the raw line-delimited file directly — the Chrome trace parser
tolerates missing array brackets).

Timestamps are microseconds since the writer was opened (``perf_counter``
based, so spans from different threads are mutually ordered).
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Iterator, List, Optional

_REQUIRED_KEYS = {"name", "ph", "ts", "pid", "tid"}


class NullTracer:
    """No-op tracer with the TraceWriter API; used when tracing is off."""

    path: Optional[str] = None

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

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


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
