"""One metrics registry for the whole process: counters, gauges, histograms.

A copy of ``das_diff_veh_tpu/obs/registry.py`` (no JAX in it; the port keeps
its own).  Every subsystem registers labeled metric families here, and the
same registry renders as Prometheus text exposition and as a JSON snapshot,
and feeds the periodic JSONL sink of batch runs (``obs.sink``), in the JAX
package's formats, so ``scripts/obs_report.py`` reads either package's files.

Three family types, Prometheus semantics:

- :class:`Counter` — monotonic float, ``inc(by)``;
- :class:`Gauge` — settable value or a zero-arg callable evaluated at
  collection time (``set_fn`` — how queue depths and device memory stats
  stay live without a writer thread);
- :class:`Histogram` — a bounded ring of recent observations rendered as a
  Prometheus *summary* (quantile samples from the ring + monotonic
  ``_sum``/``_count``), the same reservoir the serve layer always used for
  p50/p95/p99 so recent traffic dominates without unbounded memory.

Families are labeled: ``registry.counter("das_x_total", labels=("stage",))``
returns the family, ``family.labels(stage="load")`` the child.  An
unlabeled family is its own single child.  Re-registering an existing name
returns the same family (subsystems can re-wire across engine/executor
lifetimes inside one process), but a type or label-set mismatch raises.

Everything is thread-safe; write-side operations are a dict lookup plus a
float add under a lock — cheap enough for per-chunk and per-request paths.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: quantiles rendered for every histogram, as (label value, q)
QUANTILES = (("0.5", 0.50), ("0.95", 0.95), ("0.99", 0.99))


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an already-sorted sequence (the serve
    layer's historical definition, now shared by every histogram)."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return float(sorted_vals[idx])


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(labels: Tuple[str, ...], values: Tuple[str, ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{k}="{_escape_label(str(v))}"'
             for k, v in list(zip(labels, values)) + list(extra)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Child:
    """State shared by all child kinds: one (family, label-values) cell."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock


class Counter(_Child):
    def __init__(self, lock):
        super().__init__(lock)
        self._value = 0.0

    def inc(self, by: float = 1.0) -> None:
        if by < 0:
            raise ValueError(f"counter increment must be >= 0, got {by}")
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Child):
    def __init__(self, lock):
        super().__init__(lock)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def set_fn(self, fn: Callable[[], float]) -> None:
        """Collect-time callback (live queue depths, device memory stats).
        A callback that raises or returns None reads as the last set value —
        a dead provider must not kill the scrape."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            v = fn()
        except Exception:
            v = None
        with self._lock:
            if v is not None:
                self._value = float(v)
            return self._value


class Histogram(_Child):
    """Bounded ring of recent observations + monotonic sum/count."""

    def __init__(self, lock, window: int):
        super().__init__(lock)
        self._ring = deque(maxlen=window)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self._ring.append(float(value))
            self._sum += float(value)
            self._count += 1

    def values(self) -> List[float]:
        """The ring contents, sorted (feed to :func:`percentile`)."""
        with self._lock:
            return sorted(self._ring)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentiles(self, qs=(0.50, 0.95, 0.99)) -> Dict[str, float]:
        vals = self.values()
        out = {f"p{int(q * 100)}": percentile(vals, q) for q in qs}
        out["n"] = len(vals)
        out["max"] = vals[-1] if vals else 0.0
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family; children keyed by label-value tuples."""

    def __init__(self, name: str, kind: str, help: str,
                 labels: Tuple[str, ...], window: int = 1024):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = labels
        self._window = window
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not labels:                      # unlabeled family is its own child
            self._default = self._make()
            self._children[()] = self._default

    def _make(self) -> _Child:
        if self.kind == "histogram":
            return Histogram(self._lock, self._window)
        return _KINDS[self.kind](self._lock)

    def labels(self, **kv):
        if set(kv) != set(self.label_names):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.label_names}, got {tuple(kv)}")
        key = tuple(str(kv[k]) for k in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make()
                self._children[key] = child
        return child

    def children(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    # unlabeled families proxy the child API directly
    def inc(self, by: float = 1.0) -> None:
        self._default.inc(by)

    def set(self, value: float) -> None:
        self._default.set(value)

    def set_fn(self, fn) -> None:
        self._default.set_fn(fn)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    def values(self) -> List[float]:
        return self._default.values()

    def percentiles(self, qs=(0.50, 0.95, 0.99)) -> Dict[str, float]:
        return self._default.percentiles(qs)

    @property
    def value(self) -> float:
        return self._default.value

    @property
    def count(self) -> int:
        return self._default.count

    @property
    def sum(self) -> float:
        return self._default.sum


class MetricsRegistry:
    """Thread-safe name -> :class:`Family` map with two renderers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}

    def _register(self, name: str, kind: str, help: str,
                  labels: Iterable[str], window: int = 1024) -> Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = tuple(labels)
        for lbl in labels:
            if not _LABEL_RE.match(lbl):
                raise ValueError(f"invalid label name {lbl!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}, not {kind}{labels}")
                return fam
            fam = Family(name, kind, help, labels, window)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Family:
        return self._register(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Family:
        return self._register(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "", labels: Iterable[str] = (),
                  window: int = 1024) -> Family:
        return self._register(name, "histogram", help, labels, window=window)

    def get(self, name: str) -> Optional[Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # -- renderers -----------------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition (format version 0.0.4).  Histograms
        render as summaries: quantile samples from the bounded ring plus
        monotonic ``_sum``/``_count``."""
        lines: List[str] = []
        for fam in self.families():
            ptype = "summary" if fam.kind == "histogram" else fam.kind
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {ptype}")
            for key, child in fam.children():
                if fam.kind == "histogram":
                    vals = child.values()
                    for qlabel, q in QUANTILES:
                        lbl = _fmt_labels(fam.label_names, key,
                                          (("quantile", qlabel),))
                        lines.append(
                            f"{fam.name}{lbl} {percentile(vals, q):g}")
                    base = _fmt_labels(fam.label_names, key)
                    lines.append(f"{fam.name}_sum{base} {child.sum:g}")
                    lines.append(f"{fam.name}_count{base} {child.count}")
                else:
                    lbl = _fmt_labels(fam.label_names, key)
                    lines.append(f"{fam.name}{lbl} {child.value:g}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        """One JSON-ready dict: ``{name: {kind, [help], values}}`` where
        ``values`` maps rendered label strings to the child's value (or
        percentile dict for histograms)."""
        out: Dict[str, dict] = {}
        for fam in self.families():
            vals = {}
            for key, child in fam.children():
                lbl = _fmt_labels(fam.label_names, key) or "()"
                if fam.kind == "histogram":
                    p = child.percentiles()
                    p["sum"] = child.sum
                    p["count"] = child.count
                    vals[lbl] = p
                else:
                    vals[lbl] = child.value
            out[fam.name] = {"kind": fam.kind, "values": vals}
            if fam.help:
                out[fam.name]["help"] = fam.help
        return out

    def snapshot_line(self) -> dict:
        """One JSONL sink line: wall-clock timestamp + the full JSON dump."""
        return {"ts": time.time(), "metrics": self.to_json()}


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry.  Batch runs, the parallel engines, and
    the serve CLI all register here so one scrape / one JSONL sink carries
    every subsystem; tests and embedded engines build their own
    :class:`MetricsRegistry` for isolation."""
    return _DEFAULT
