"""Crash flight recorder: a bounded ring of recent work records, dumped on
failure (a copy of ``das_diff_veh_tpu/obs/flight.py``, same dump format).

When a chunk is quarantined or a request is shed, the quarantine/shed
counter says *that* it happened; the flight recorder preserves *what was in
flight when it happened* — the last N per-chunk / per-request records
(shapes, bucket, config hash, stage timings, error or shed cause) — as a
JSON artifact a human can read after the process is gone.  Recording is a
dict append into a deque (cheap enough for every request); dumping happens
only on the failure paths:

- ``runtime/executor.py`` — every chunk is recorded; a quarantine dumps;
- SIGTERM/SIGINT — :meth:`install_signal_handlers` dumps on the way out
  (chaining to the previous handler, so shutdown semantics are unchanged).

Auto-dumps are rate-limited per reason (``min_dump_interval_s``) so a shed
storm produces one artifact per window, not one per request; an explicit
``dump(..., force=True)`` always writes.  ``scripts/obs_report.py`` joins a
dump with the trace and metrics JSONL into one report.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# process-wide dump sequence: two recorders with the same name in one
# process (A/B reps, a re-run date after resume) must not overwrite
# each other's artifacts, so the filename counter cannot be per-instance
_DUMP_SEQ = itertools.count()


class FlightRecorder:
    """Thread-safe bounded ring of recent records + JSON dump on demand.

    With ``out_dir=None`` the ring still records (``records()`` for tests
    and embedders) but auto-dump calls are no-ops — the recorder is always
    safe to wire in.
    """

    def __init__(self, capacity: int = 256, out_dir: Optional[str] = None,
                 name: str = "flight", min_dump_interval_s: float = 1.0):
        self.capacity = int(capacity)
        self.out_dir = out_dir
        self.name = name
        self.min_dump_interval_s = float(min_dump_interval_s)
        # reentrant: the SIGTERM handler runs dump(force=True) on the main
        # thread, which may already be inside record()/dump() holding this
        # lock — a plain Lock would deadlock the exact shutdown path the
        # recorder exists to cover
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._n_recorded = 0
        self._n_dumps = 0
        self._last_dump: Dict[str, float] = {}      # reason -> monotonic s
        self._prev_handlers: dict = {}

    # -- write side ----------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one record; ``kind`` tags the record type ("chunk",
        "request", "shed", "error", ...)."""
        rec = {"ts": time.time(), "kind": kind}
        rec.update(fields)
        with self._lock:
            self._ring.append(rec)
            self._n_recorded += 1

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    @property
    def n_dumps(self) -> int:
        with self._lock:
            return self._n_dumps

    # -- dump ----------------------------------------------------------------
    def dump(self, reason: str, path: Optional[str] = None,
             force: bool = False, **context) -> Optional[str]:
        """Write the ring to a JSON artifact; returns the path, or None when
        suppressed (no ``out_dir`` and no explicit ``path``, or the same
        reason dumped within ``min_dump_interval_s`` and not ``force``)."""
        now = time.monotonic()
        with self._lock:
            if path is None:
                if self.out_dir is None:
                    return None
                last = self._last_dump.get(reason, -1e18)
                if not force and now - last < self.min_dump_interval_s:
                    return None
                path = os.path.join(
                    self.out_dir,
                    f"{self.name}_{reason}_{os.getpid()}_"
                    f"{next(_DUMP_SEQ)}.json")
            self._last_dump[reason] = now
            self._n_dumps += 1
            payload = {"reason": reason, "dumped_at": time.time(),
                       "pid": os.getpid(), "n_recorded": self._n_recorded,
                       "capacity": self.capacity, "context": context,
                       "records": list(self._ring)}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        os.replace(tmp, path)
        return path

    # -- signals -------------------------------------------------------------
    def install_signal_handlers(
            self, signals=(signal.SIGTERM, signal.SIGINT)) -> bool:
        """Dump (reason ``sig<N>``) before chaining to the previous handler
        (for SIGINT that chain ends in the default KeyboardInterrupt, so
        Ctrl-C semantics are unchanged).  Only possible on the main thread
        — returns False (and installs nothing) elsewhere, so callers can
        wire this unconditionally."""
        def _handler(signum, frame):
            self.dump(f"sig{signum}", force=True)
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)

        try:
            for s in signals:
                self._prev_handlers[s] = signal.signal(s, _handler)
        except ValueError:          # not the main thread
            return False
        return True

    def uninstall_signal_handlers(self) -> None:
        for s, prev in list(self._prev_handlers.items()):
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
            del self._prev_handlers[s]


def load_flight_dump(path: str) -> dict:
    """Parse + validate a dump artifact (raises ValueError on bad schema)."""
    with open(path) as f:
        payload = json.load(f)
    missing = {"reason", "dumped_at", "records"} - set(payload)
    if missing:
        raise ValueError(f"{path}: flight dump missing keys {missing}")
    if not isinstance(payload["records"], list):
        raise ValueError(f"{path}: records is not a list")
    return payload
