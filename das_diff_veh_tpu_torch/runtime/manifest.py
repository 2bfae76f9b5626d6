"""Per-run resume manifest: config hash + per-chunk done/quarantined status.

Replaces skip-if-output-exists resume (reference imaging_workflow.py:189-191)
with exact mid-date resume: the manifest records every chunk file's status
and the partial accumulator is checkpointed alongside it, so an interrupted
run restarts at the first unprocessed chunk and reproduces the uninterrupted
result bit-for-bit (chunks accumulate in sorted file order, and a resumed
run continues the same order from the saved prefix sum).

The manifest is keyed on a hash of everything that determines output values
(PipelineConfig, method, dataset preprocessing knobs) so stale outputs from
an older configuration are invalidated instead of silently skipped.
RuntimeConfig is excluded on purpose — prefetch depth or retry policy never
changes a bit of output.

A copy of ``das_diff_veh_tpu/runtime/manifest.py`` with one change: every
hash starts with the part :data:`RUN_HASH_PART`.  The two packages' bits
differ (another framework, float32 on the card), so a port run never resumes
an accumulator or a manifest that the JAX package wrote, and the reverse.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Optional

MANIFEST_VERSION = 1

RUN_HASH_PART = "das_diff_veh_tpu_torch"

STATUS_DONE = "done"
STATUS_QUARANTINED = "quarantined"


def config_hash(*parts) -> str:
    """Deterministic hash of config-ish objects via their repr.

    Frozen dataclass reprs are stable field-ordered renderings, which makes
    repr a faithful value fingerprint for the config tree (callables inside,
    if any, would not be — none of the hashed configs carry them).
    """
    h = hashlib.sha256()
    for p in (RUN_HASH_PART, *parts):
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def _atomic_write_json(path: str, payload: dict) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@dataclass
class RunManifest:
    """Status of one date-directory run, persisted as JSON."""

    path: str
    config_hash: str
    date: str = ""
    complete: bool = False
    files: Dict[str, dict] = field(default_factory=dict)
    """basename -> {"status": done|quarantined, "n_windows": int,
    "error": str, "stage": str, "retries": int, "health": dict}
    (keys per status; "health" only on chunks the input-health sentinel
    degraded — masked channels, NaN fraction — so a resumed run still
    knows which of its accumulated chunks ran in degraded mode)."""

    # -- persistence ---------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> Optional["RunManifest"]:
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                d = json.load(f)
        except (json.JSONDecodeError, OSError):
            return None           # unreadable manifest == no manifest
        if d.get("version") != MANIFEST_VERSION:
            return None
        return cls(path=path, config_hash=d.get("config_hash", ""),
                   date=d.get("date", ""), complete=bool(d.get("complete")),
                   files=d.get("files", {}))

    def save(self) -> None:
        _atomic_write_json(self.path, {
            "version": MANIFEST_VERSION, "config_hash": self.config_hash,
            "date": self.date, "complete": self.complete, "files": self.files})

    # -- status accounting ---------------------------------------------------
    def status(self, key: str) -> Optional[str]:
        entry = self.files.get(key)
        return entry["status"] if entry else None

    def is_settled(self, key: str) -> bool:
        """Done or quarantined — nothing left to do for this chunk."""
        return self.status(key) in (STATUS_DONE, STATUS_QUARANTINED)

    def mark_done(self, key: str, n_windows: int, retries: int = 0,
                  health: Optional[dict] = None) -> None:
        entry = {"status": STATUS_DONE, "n_windows": int(n_windows),
                 "retries": int(retries)}
        if health:     # degraded-mode provenance (masked channels etc.)
            entry["health"] = health
        self.files[key] = entry

    def mark_quarantined(self, key: str, stage: str, error: str,
                         retries: int = 0) -> None:
        self.files[key] = {"status": STATUS_QUARANTINED, "stage": stage,
                           "error": error[:500], "retries": int(retries)}

    def clear_quarantined(self) -> int:
        """Drop every quarantine record so those chunks re-enter the work
        list (``RuntimeConfig.retry_quarantined``); returns how many."""
        keys = [k for k, e in self.files.items()
                if e["status"] == STATUS_QUARANTINED]
        for k in keys:
            del self.files[k]
        return len(keys)

    @property
    def n_vehicles(self) -> int:
        return sum(e.get("n_windows", 0) for e in self.files.values()
                   if e["status"] == STATUS_DONE)

    @property
    def n_chunks(self) -> int:
        """Chunks that contributed to the accumulator (done, >=1 window)."""
        return sum(1 for e in self.files.values()
                   if e["status"] == STATUS_DONE and e.get("n_windows", 0) > 0)

    @property
    def quarantined(self) -> Dict[str, dict]:
        return {k: e for k, e in self.files.items()
                if e["status"] == STATUS_QUARANTINED}

    @property
    def degraded(self) -> Dict[str, dict]:
        """Done chunks that ran with health-masked channels."""
        return {k: e for k, e in self.files.items()
                if e["status"] == STATUS_DONE and e.get("health")}
