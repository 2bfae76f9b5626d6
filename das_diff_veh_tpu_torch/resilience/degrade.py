"""The degradation ladder: lose capability, not the run.

A copy of ``das_diff_veh_tpu/resilience/degrade.py``.  Three tiers of the
pipeline have a plainer fallback underneath, and the ladder switches to it
automatically, visibly and for good:

1. **unhealthy channels masked** (rung 0, per chunk): the health sentinel
   (:mod:`resilience.health`) zeroes or imputes bad channels; the batch
   workflow counts such chunks (``das_health_degraded_chunks_total``);
2. **gather kernel -> serialized cut** (component ``"gather.fused"``): after
   a compute failure of the default chunk on the card, the trajectory
   gather's kernels (B1, B2) are demoted, so ``GatherConfig.traj_gather=
   "auto"`` resolves to the serialized cut (``ops.xcorr._decide_traj_gather``
   consults :func:`demoted`) for the retry and every later chunk, and the
   fused chunk captures a new program without them;
3. **ring -> replicated -> einsum** (component ``"parallel.ring"``): a failed
   all-pairs ring falls back to the replicated layout, and a failure there
   to the einsum without kernels (:func:`resilient_all_pairs_peak`).

Demotions are process-wide and sticky (a flaking kernel is not retried per
chunk), and each one is counted (``das_degrade_transitions_total{component}``),
shown (``das_degrade_active{component}`` at 1), flight-recorded (``"degrade"``)
and logged as a warning.  :func:`reset` restores full capability.  Nothing
else in the port falls back: the sharded entries and the kernel wrappers
raise.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, Optional

log = logging.getLogger("das_diff_veh_tpu_torch.resilience")

#: ladder components with automatic fallbacks
GATHER_FUSED = "gather.fused"
PARALLEL_RING = "parallel.ring"


class DegradationLadder:
    """Failure count -> sticky demotion, with the obs wiring.

    ``threshold`` failures of a component demote it (default 1: the first
    failure already cost a retry).  ``flight`` is optional; when given,
    every transition lands a ``"degrade"`` record."""

    def __init__(self, registry=None, flight=None, threshold: int = 1):
        if registry is None:
            from das_diff_veh_tpu_torch.obs.registry import default_registry
            registry = default_registry()
        self._lock = threading.Lock()
        self._fails: Dict[str, int] = {}
        self._demoted: Dict[str, str] = {}      # component -> last error
        self.flight = flight
        self.threshold = max(int(threshold), 1)
        self._transitions = registry.counter(
            "das_degrade_transitions_total",
            "degradation-ladder demotions, by component", labels=("component",))
        self._active = registry.gauge(
            "das_degrade_active", "1 while the component runs demoted, else 0",
            labels=("component",))

    def demoted(self, component: str) -> bool:
        with self._lock:
            return component in self._demoted

    def failures(self, component: str) -> int:
        with self._lock:
            return self._fails.get(component, 0)

    def note_failure(self, component: str, error=None) -> bool:
        """Record one failure; True when the component is (now) demoted.
        Idempotent past the threshold: the counters move once."""
        err = f"{type(error).__name__}: {error}" if error is not None else ""
        with self._lock:
            self._fails[component] = self._fails.get(component, 0) + 1
            if component in self._demoted:
                return True
            if self._fails[component] < self.threshold:
                return False
            self._demoted[component] = err
        log.warning("degradation ladder: %s demoted after %d failure(s): %s",
                    component, self.failures(component), err or "(no error)")
        self._transitions.labels(component=component).inc()
        self._active.labels(component=component).set(1.0)
        if self.flight is not None:
            self.flight.record("degrade", component=component, error=err,
                               failures=self.failures(component))
        return True

    def reset(self, component: Optional[str] = None) -> None:
        with self._lock:
            comps = [component] if component else list(self._demoted)
            for c in comps:
                self._demoted.pop(c, None)
                self._fails.pop(c, None)
        for c in comps:
            self._active.labels(component=c).set(0.0)


# the process-wide ladder, consulted by ops.xcorr and the fused chunk's key
_LADDER: Optional[DegradationLadder] = None
_LADDER_LOCK = threading.Lock()


def ladder() -> DegradationLadder:
    """The process ladder (built on first use against the default registry)."""
    global _LADDER
    with _LADDER_LOCK:
        if _LADDER is None:
            _LADDER = DegradationLadder()
        return _LADDER


def set_ladder(lad: Optional[DegradationLadder]) -> None:
    global _LADDER
    with _LADDER_LOCK:
        _LADDER = lad


def demoted(component: str) -> bool:
    """Cheap process-wide consult: False when no ladder was ever built (one
    global read, no allocation)."""
    lad = _LADDER
    return lad is not None and lad.demoted(component)


def note_failure(component: str, error=None) -> bool:
    return ladder().note_failure(component, error)


def reset(component: Optional[str] = None) -> None:
    lad = _LADDER
    if lad is not None:
        lad.reset(component)


def resilient_all_pairs_peak(data, wlen: int, mesh, *, ring=None,
                             lad: Optional[DegradationLadder] = None, **kw):
    """``parallel.allpairs.sharded_all_pairs_peak`` behind the ladder.

    Tries the configured decomposition (the ring unless it is demoted),
    falls back to the replicated layout on a failure and to the einsum
    without kernels (``use_kernel=False``) on a second one, recording each
    transition.  ``ValueError`` and ``TypeError`` (input validation, e.g. a
    negative ``win_block``) re-raise untouched: every rung would fail alike,
    so they demote nothing.  Raises when the last rung fails too.

    On a mesh across processes every rank takes the same rung: a demotion
    on any rank puts every rank on the replicated layout (an all-reduce
    before the call), and the sharded entry raises the same kind on every
    rank together: a refused input as a ``ValueError`` everywhere
    (``distributed.PeerInvalid`` on the other ranks), which demotes no
    ladder, any other failure as itself or ``distributed.PeerFailure``, which
    demotes every ladder; so the retries stay in step."""
    from das_diff_veh_tpu_torch.config import RingConfig
    from das_diff_veh_tpu_torch.parallel import distributed
    from das_diff_veh_tpu_torch.parallel.allpairs import sharded_all_pairs_peak

    lad = lad if lad is not None else ladder()
    cfg = ring if ring is not None else RingConfig()
    demoted = lad.demoted(PARALLEL_RING)
    if mesh.multiprocess:
        demoted = distributed.any_rank(demoted, mesh.devices[mesh.local_slots[0]])
    if cfg.mode == "ring" and demoted:
        cfg = dataclasses.replace(cfg, mode="replicated")
    try:
        return sharded_all_pairs_peak(data, wlen, mesh, ring=cfg, **kw)
    except (ValueError, TypeError):      # validation, not dispatch: no rung
        raise
    except Exception as e:  # noqa: BLE001 - any dispatch failure degrades
        if cfg.mode != "ring":
            # already replicated: drop the kernels too, unless the caller had
            # them off, when the retry would be the call that just failed
            if kw.get("use_kernel") is False:
                raise
            lad.note_failure(PARALLEL_RING, e)
            return sharded_all_pairs_peak(data, wlen, mesh, ring=cfg,
                                          **dict(kw, use_kernel=False))
        lad.note_failure(PARALLEL_RING, e)
        cfg = dataclasses.replace(cfg, mode="replicated")
        try:
            return sharded_all_pairs_peak(data, wlen, mesh, ring=cfg, **kw)
        except Exception as e2:  # noqa: BLE001
            lad.note_failure(PARALLEL_RING, e2)
            if kw.get("use_kernel") is False:
                raise
            return sharded_all_pairs_peak(data, wlen, mesh, ring=cfg,
                                          **dict(kw, use_kernel=False))
