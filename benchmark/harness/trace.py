"""Spans, counters and the device trace of a run, kept in memory.

:class:`MemTracer` has the program's tracer interface (``span``,
``complete``, ``counter``, ``instant``, ``now_us``), so it can be handed to
``run_directory`` and ``ServingEngine``.  Its clock is ``time.perf_counter``
in microseconds, the harness's own clock.  :class:`DeviceProfile` wraps
``torch.profiler`` over a steady part of the window and reduces the kernels
it saw to busy time, time by kernel and idle gaps.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Optional


class MemTracer:
    """In-memory tracer.  ``record_spans=False`` keeps only counters, for
    the untraced run; ``on_counter(name, values)`` is called on every
    counter, in the thread that emits it."""

    def __init__(self, record_spans: bool = True,
                 on_counter: Optional[Callable[[str, dict], None]] = None):
        self.record_spans = record_spans
        self.on_counter = on_counter
        self.spans: list = []
        self.totals: dict = {}          # span name -> [count, microseconds]
        self.path = None

    def now_us(self) -> float:
        return time.perf_counter() * 1e6

    def complete(self, name: str, start_us: float, cat: str = "runtime", **args) -> None:
        dur = max(self.now_us() - start_us, 0.0)
        tot = self.totals.setdefault(name, [0, 0.0])
        tot[0] += 1
        tot[1] += dur
        if self.record_spans:
            self.spans.append({"name": name, "ts": start_us, "dur": dur,
                               "tid": threading.get_ident(), "args": args})

    @contextmanager
    def span(self, name: str, cat: str = "runtime", **args):
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, t0, cat=cat, **args)

    def counter(self, name: str, **values) -> None:
        if self.on_counter is not None:
            self.on_counter(name, values)

    def instant(self, name: str, **args) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


@dataclass
class DeviceSummary:
    """What one profiled stretch of the window shows of the device."""

    busy_s: float                     # union of device activity
    window_s: float                   # host clock from start to stop
    kernel_s: dict                    # device seconds by operation name
    gaps: list                        # [[label, seconds], ...] longest first
    t0: float = 0.0                   # perf_counter at start and stop
    t1: float = 0.0

    def seconds(self, match: Callable[[str], bool]) -> float:
        return sum(s for n, s in self.kernel_s.items() if match(n))

    def top_ops(self, k: int = 10) -> list:
        return [[n, s] for n, s in sorted(self.kernel_s.items(), key=lambda x: -x[1])[:k]]


def _is_cuda(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def _label_gaps(gaps: list, host: list, k: int = 10) -> list:
    """The ``k`` longest idle gaps, each labelled by what the host was
    doing at its middle: the innermost user annotation covering it, else
    the innermost host operation, else ``idle host``."""
    out = []
    for start, end in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
        mid = (start + end) // 2
        best = None
        for s, e, name, annot in host:
            if s <= mid <= e:
                key = (not annot, e - s)
                if best is None or key < best[0]:
                    best = (key, name)
        out.append([best[1] if best else "idle host", (end - start) / 1e9])
    return out


class DeviceProfile:
    """``torch.profiler`` over CPU and CUDA activity, started and stopped
    by the harness between units of work."""

    def __init__(self):
        self.summary: Optional[DeviceSummary] = None
        self._prof = None
        self._t0 = 0.0
        self.active = False

    @staticmethod
    def warm() -> None:
        """Start and stop one profile over a trivial operation: the first
        start of a process initialises the device tracer, which takes
        seconds, and belongs in set-up."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu").sum().item()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        """Stop tracing; the trace is reduced later, by :meth:`finish`, so
        that the reduction does not hold up the window."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        self._prof.stop()
        self.active = False

    def finish(self) -> Optional[DeviceSummary]:
        """Stop if still tracing, reduce the trace once, and return it."""
        if self.active:
            self.stop()
        if self._prof is not None:
            self.summary = self._reduce(self._prof, self._t0, self._t1)
            self._prof = None
        return self.summary

    @staticmethod
    def _reduce(prof, t0: float, t1: float) -> DeviceSummary:
        events = prof.profiler.kineto_results.events()
        dev, host = [], []
        kernel_s: dict = {}
        for ev in events:
            s, d = ev.start_ns(), ev.duration_ns()
            if _is_cuda(ev):
                name = ev.name()
                dev.append((s, s + d))
                kernel_s[name] = kernel_s.get(name, 0.0) + d / 1e9
            else:
                host.append((s, s + d, ev.name(), bool(ev.is_user_annotation())))
        dev.sort()
        busy, gaps = 0, []
        cur_s = cur_e = None
        for s, e in dev:
            if cur_e is None:
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return DeviceSummary(busy_s=busy / 1e9, window_s=t1 - t0, kernel_s=kernel_s,
                             gaps=_label_gaps(gaps, host), t0=t0, t1=t1)


@dataclass
class Readings:
    """What the per-layer metric readers are given."""

    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)   # program counters after the window
    device: Optional[DeviceSummary] = None
    units: int = 0                                  # units completed in the window
    profiled_units: int = 0                         # units done inside the profile
    harness: dict = field(default_factory=dict)     # the harness's own timings
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)

    def span_ms(self, *names: str) -> list:
        return [s["dur"] / 1e3 for s in self.spans if s["name"] in names]


def before(spans: list, t_us: Optional[float]) -> list:
    """The spans that ended before ``t_us`` (all when ``t_us`` is None):
    the span metrics of a traced run are read before its profile starts, so
    that the profiler's own cost does not reach them."""
    return spans if t_us is None else [s for s in spans if s["ts"] + s["dur"] <= t_us]
