"""Deterministic, seeded fault injection: named sites, zero overhead off.

A copy of ``das_diff_veh_tpu/resilience/faults.py`` (numpy only): the same
sites, kinds and per-``(seed, site, key)`` draws, so one plan corrupts the
same samples in either package.  The batch runtime survives bad inputs
through per-chunk retry/quarantine and the flight recorder; this module
exercises that machinery against realistic interrogator faults.  A
:class:`FaultPlan` names which
fault fires at which **site** (a string like ``"io.read"``) for which
**key** (a chunk filename, a request index), and the production code paths
carry one-line ``faults.fire(site, key)`` / ``faults.corrupt(site, key,
data)`` hooks at those sites.

Sites wired through the port (grep for the literal string):

- ``io.read``      — loader failure (:func:`io.readers.read_npz_section`);
- ``io.slow``      — slow read latency (same place);
- ``io.corrupt``   — NaN/Inf bursts, dead or clipped channels injected into
  the loaded waterfall (same place, after decode AND after the ch1/ch2 /
  taper cuts, so channel indices match what the pipeline sees);
- ``runtime.compute`` — per-chunk compute dispatch failure
  (``runtime/executor.run_pipelined``);
- ``runtime.slow`` — slow-chunk latency in the compute stage (same place).

The JAX package also wires ``serve.dispatch`` and ``parallel.ring``; their
modules are not ported yet (ROADMAP items 12 and 11).

Everything is **off by default and free when off**: the module-level hooks
read one global and return (``_ACTIVE is None`` — no allocation, no lock).
Injection is explicit (:func:`install` / the :func:`injected` context
manager), deterministic (corruption draws from a per-``(seed, site, key)``
``np.random.default_rng``, so a retry of the same chunk refires the same
fault — exactly what sends a persistently-bad chunk through the retry
ladder into quarantine), and observable (every injection increments
``das_faults_injected_total{site,kind}`` and lands a flight record when a
recorder is attached).
"""

from __future__ import annotations

import hashlib
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

#: fault kinds understood by the injector
ERROR_KINDS = ("error",)
LATENCY_KINDS = ("slow",)
DATA_KINDS = ("nan", "inf", "dead", "clip")
KINDS = ERROR_KINDS + LATENCY_KINDS + DATA_KINDS


class InjectedFault(RuntimeError):
    """Raised by an ``error``-kind spec; carries its site for assertions."""

    def __init__(self, site: str, key):
        super().__init__(f"injected fault at {site} (key={key})")
        self.site = site
        self.key = key


@dataclass(frozen=True)
class FaultSpec:
    """One fault rule: fire ``kind`` at ``site`` for the listed ``keys``.

    ``keys`` empty means the spec fires on *every* call at the site.
    ``param`` is kind-specific: seconds for ``slow``, the fraction of
    channels to corrupt for the data kinds (``channels`` overrides the
    seeded choice with explicit indices), the saturation amplitude for
    ``clip`` (falls back to 1.0 when 0).
    """

    site: str
    kind: str
    keys: Tuple[str, ...] = ()
    param: float = 0.0
    channels: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")

    def matches(self, key) -> bool:
        return not self.keys or str(key) in self.keys


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, explicit set of fault specs — the chaos campaign input.

    The plan is data, not behavior: tests assert quarantine/degradation
    counts *against the plan* (``n_keys(site)``), so the expected outcome
    is derived from the same object that drives the injection.
    """

    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0

    def n_keys(self, site: str) -> int:
        """Distinct keys targeted at ``site`` (0-key specs count as 0 —
        they are rate faults, not countable plan entries)."""
        keys = set()
        for s in self.specs:
            if s.site == site:
                keys.update(s.keys)
        return len(keys)

    @classmethod
    def sample(cls, seed: int, keys: Sequence[str], *,
               n_loader_faults: int = 0, n_corrupt: int = 0,
               corrupt_kind: str = "nan",
               corrupt_fraction: float = 0.1) -> "FaultPlan":
        """Deterministically pick disjoint loader-fault and corrupt-chunk
        key sets from ``keys`` — the canonical chaos-campaign shape."""
        if n_loader_faults + n_corrupt > len(keys):
            raise ValueError(f"plan wants {n_loader_faults}+{n_corrupt} "
                             f"faulted keys but only {len(keys)} exist")
        rng = np.random.default_rng(seed)
        picked = rng.choice(len(keys), size=n_loader_faults + n_corrupt,
                            replace=False)
        loader = tuple(sorted(str(keys[i]) for i in picked[:n_loader_faults]))
        corrupt = tuple(sorted(str(keys[i]) for i in picked[n_loader_faults:]))
        specs: List[FaultSpec] = []
        if loader:
            specs.append(FaultSpec("io.read", "error", keys=loader))
        if corrupt:
            specs.append(FaultSpec("io.corrupt", corrupt_kind, keys=corrupt,
                                   param=corrupt_fraction))
        return cls(specs=tuple(specs), seed=seed)


def _spec_rng(seed: int, site: str, key) -> np.random.Generator:
    """Deterministic per-(seed, site, key) generator: the same chunk gets
    the same corruption on every attempt (retries included)."""
    h = hashlib.sha256(f"{seed}|{site}|{key}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


class FaultInjector:
    """Evaluates a :class:`FaultPlan` at the wired sites, with counters.

    ``registry`` defaults to the process obs registry; ``flight`` is
    optional — when given, every injection lands a ``"fault"`` record so a
    post-mortem dump shows what chaos was active.
    """

    def __init__(self, plan: FaultPlan, registry=None, flight=None):
        self.plan = plan
        self.flight = flight
        if registry is None:
            from das_diff_veh_tpu_torch.obs.registry import default_registry
            registry = default_registry()
        self._counter = registry.counter(
            "das_faults_injected_total",
            "chaos faults injected, by site and kind",
            labels=("site", "kind"))
        self.n_injected = 0

    # -- bookkeeping ---------------------------------------------------------
    def _note(self, spec: FaultSpec, key) -> None:
        self.n_injected += 1
        self._counter.labels(site=spec.site, kind=spec.kind).inc()
        if self.flight is not None:
            self.flight.record("fault", site=spec.site, fault_kind=spec.kind,
                               key=str(key), param=spec.param)

    # -- site hooks ----------------------------------------------------------
    def fire(self, site: str, key=None) -> None:
        """Apply control-flow faults at ``site``: sleep for ``slow`` specs,
        raise :class:`InjectedFault` for ``error`` specs (latency first, so
        a slow+error site pays the latency before failing, like a hung
        read that finally times out)."""
        for spec in self.plan.specs:
            if spec.site != site or not spec.matches(key):
                continue
            if spec.kind == "slow":
                self._note(spec, key)
                time.sleep(spec.param)
        for spec in self.plan.specs:
            if (spec.site == site and spec.kind == "error"
                    and spec.matches(key)):
                self._note(spec, key)
                raise InjectedFault(site, key)

    def corrupt(self, site: str, key, data: np.ndarray) -> np.ndarray:
        """Apply data faults at ``site``; returns a corrupted *copy* when a
        spec fires, the original array untouched otherwise."""
        out = None
        for spec in self.plan.specs:
            if (spec.site != site or spec.kind not in DATA_KINDS
                    or not spec.matches(key)):
                continue
            if out is None:
                out = np.array(data, copy=True)
            self._apply_data_fault(spec, key, out)
            self._note(spec, key)
        return data if out is None else out

    def _apply_data_fault(self, spec: FaultSpec, key,
                          out: np.ndarray) -> None:
        nch, nt = out.shape[0], out.shape[-1]
        rng = _spec_rng(self.plan.seed, spec.site, key)
        if spec.channels:
            chans = [c for c in spec.channels if 0 <= c < nch]
        else:
            n_bad = max(1, int(round(spec.param * nch)))
            chans = sorted(rng.choice(nch, size=min(n_bad, nch),
                                      replace=False).tolist())
        for c in chans:
            if spec.kind == "dead":
                out[c] = 0.0
            elif spec.kind == "clip":
                lim = spec.param if spec.param > 0 else 1.0
                out[c] = np.sign(out[c] + 0.5) * lim   # hard-saturated rail
            else:                                      # nan / inf burst
                burst = max(1, int(0.25 * nt))
                start = int(rng.integers(0, max(nt - burst, 1)))
                out[c, start:start + burst] = (
                    np.nan if spec.kind == "nan" else np.inf)


# --------------------------------------------------------------------------
# module-level hooks — the only thing production code touches
# --------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None


def install(plan_or_injector, registry=None, flight=None) -> FaultInjector:
    """Activate injection process-wide; returns the injector.  Accepts a
    ready :class:`FaultInjector` or builds one from a :class:`FaultPlan`."""
    global _ACTIVE
    if isinstance(plan_or_injector, FaultInjector):
        _ACTIVE = plan_or_injector
    else:
        _ACTIVE = FaultInjector(plan_or_injector, registry=registry,
                                flight=flight)
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


@contextmanager
def injected(plan_or_injector, registry=None, flight=None):
    """``with faults.injected(plan): ...`` — scoped chaos, always cleaned."""
    inj = install(plan_or_injector, registry=registry, flight=flight)
    try:
        yield inj
    finally:
        uninstall()


def fire(site: str, key=None) -> None:
    """Production-side hook: no-op (one global read) unless an injector is
    installed AND has a spec for this site/key."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(site, key)


def corrupt(site: str, key, data):
    """Production-side data hook: returns ``data`` untouched (no copy, no
    inspection) unless an injector is installed."""
    inj = _ACTIVE
    if inj is None:
        return data
    return inj.corrupt(site, key, data)
