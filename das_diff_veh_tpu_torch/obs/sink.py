"""Periodic JSONL metrics sink: the batch-run counterpart of ``/metrics``
(a copy of ``das_diff_veh_tpu/obs/sink.py``, same line format).

An online engine is scraped; a batch run has no listener to scrape it, so
the sink inverts the direction — a daemon thread appends one JSON line
(``{"ts": ..., "metrics": registry.to_json()}``) every ``interval_s``
seconds, plus one final line at :meth:`close` so even a sub-interval run
leaves a complete last snapshot.  Line-delimited JSON for the same reason
as the Chrome-trace writer: a killed run keeps every completed line.

``scripts/obs_report.py`` renders the last line of this file next to the
trace spans and any flight-recorder dump.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List

from das_diff_veh_tpu_torch.obs.registry import MetricsRegistry


class MetricsSink:
    """Append registry snapshots to ``path`` every ``interval_s`` seconds."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: float = 10.0):
        self.registry = registry
        self.path = path
        self.interval_s = max(float(interval_s), 0.05)
        # append, not truncate: run_date_range builds one sink per date
        # against the same path, and a resumed run must keep the earlier
        # run's snapshots (same contract as the flight recorder's makedirs)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="obs-metrics-sink", daemon=True)
        self._thread.start()

    def _write_line(self) -> None:
        line = json.dumps(self.registry.snapshot_line())
        with self._lock:
            if not self._f.closed:
                self._f.write(line + "\n")
                self._f.flush()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write_line()

    def flush(self) -> None:
        """Write one snapshot line now (tests, checkpoints)."""
        self._write_line()

    def close(self) -> None:
        """Stop the thread, write the final snapshot, close the file."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._write_line()
        with self._lock:
            if not self._f.closed:
                self._f.close()


def load_metrics_jsonl(path: str) -> List[dict]:
    """Parse a sink file; raises ValueError on a malformed line."""
    out = []
    with open(path) as f:
        for n, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                snap = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{n}: not valid JSON: {e}") from e
            if not isinstance(snap, dict) or "ts" not in snap \
                    or "metrics" not in snap:
                raise ValueError(f"{path}:{n}: missing ts/metrics keys")
            out.append(snap)
    return out
