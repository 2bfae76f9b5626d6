"""Input-health sentinel: one screen per chunk, a per-channel mask.

The port of ``das_diff_veh_tpu/resilience/health.py``.  Real interrogators
emit NaN/Inf bursts, flatlined channels, and saturated rails; the imaging
pipeline's FFT chains turn ONE non-finite sample into a fully-poisoned
dispersion image.  The sentinel screens a waterfall *before* the pipeline
sees it:

- **one pass on the data's device** (``_screen``) — NaN/Inf counts, the
  peak-to-peak flatline test, the clip fraction per channel, and the
  sanitized data.  XLA lowered the JAX screen on its own, so its port is
  plain torch ops (on the card: a handful of elementwise and reduction
  kernels), not a kernel of its own.  Every operation in it is exact
  (``isfinite``, ``amax``/``amin``, ``where``, the mean of a boolean, the
  sum of two neighbours), so the card's screen is ``torch.equal`` to the
  CPU's screen of the same data, and the CPU screen of float64 data is bit
  for bit the JAX screen;
- **mask-aware sanitization** — non-finite samples become 0, unhealthy
  channels are zeroed (and neighbor-imputed with
  :func:`~das_diff_veh_tpu_torch.ops.qc.impute_traces` when
  ``HealthConfig.impute``);
- **zero cost when off** — ``HealthConfig.enabled`` is False by default and
  every call site checks it before calling in here; the per-tag counters
  below let tests *assert* that a disabled screen never runs.

The host-side :func:`quick_screen` is the serve-admission variant: plain
numpy, no device work.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import HealthConfig
from .qc import impute_traces
from .section import DasSection

# per-call-site screen accounting: tests assert e.g. that the default
# (disabled) config never screens inside process_chunk
_SCREENS_LOCK = threading.Lock()
SCREENS_BY_TAG: Dict[str, int] = {}


def n_screens(tag: Optional[str] = None) -> int:
    with _SCREENS_LOCK:
        if tag is not None:
            return SCREENS_BY_TAG.get(tag, 0)
        return sum(SCREENS_BY_TAG.values())


def _count_screen(tag: str) -> None:
    with _SCREENS_LOCK:
        SCREENS_BY_TAG[tag] = SCREENS_BY_TAG.get(tag, 0) + 1


class PoisonedChunkError(RuntimeError):
    """A chunk whose masked-channel fraction exceeds
    ``HealthConfig.max_masked_fraction`` — beyond degrading, the batch path
    quarantines it instead of imaging noise."""

    def __init__(self, health: "ChannelHealth"):
        super().__init__(
            f"chunk poisoned beyond the degradation ladder: "
            f"{health.n_masked}/{health.n_channels} channels masked "
            f"(nan_fraction={health.nan_fraction:.4f}, "
            f"dead={health.n_dead}, clipped={health.n_clipped})")
        self.health = health


@dataclass(frozen=True)
class ChannelHealth:
    """Host-side screen verdict: the per-channel mask plus summary stats.

    ``healthy`` is the channel mask (True = keep); ``degraded`` says whether
    anything was masked at all (the transition the obs counters and flight
    events record).
    """

    healthy: np.ndarray                 # (nch,) bool
    nan_fraction: float                 # global non-finite sample fraction
    n_nonfinite_channels: int
    n_dead: int                         # flatline channels
    n_clipped: int

    @property
    def n_channels(self) -> int:
        return int(self.healthy.size)

    @property
    def n_masked(self) -> int:
        return int(self.n_channels - np.count_nonzero(self.healthy))

    @property
    def degraded(self) -> bool:
        return self.n_masked > 0

    def ok(self, cfg: HealthConfig) -> bool:
        """Chunk-level verdict: masked fraction within the degrading bound."""
        if self.n_channels == 0:
            return True
        return self.n_masked <= cfg.max_masked_fraction * self.n_channels

    def summary(self) -> dict:
        """Flight-record / manifest-friendly dict."""
        return {"n_masked": self.n_masked,
                "nan_fraction": round(self.nan_fraction, 6),
                "n_nonfinite_channels": self.n_nonfinite_channels,
                "n_dead": self.n_dead, "n_clipped": self.n_clipped}


def _screen(data: torch.Tensor, flatline_var: float, clip_limit: float,
            clip_fraction_max: float, impute: bool):
    """Stats + mask + sanitized data, on ``data``'s device.

    Returns ``(sanitized (nch, nt), healthy (nch,), n_nonfinite (nch,),
    n_clipped_ch scalar, n_dead scalar)``.  Flatline/clip stats are
    computed on the zero-filled data so a NaN channel cannot poison its own
    verdict.
    """
    finite = torch.isfinite(data)
    n_nonfinite = (~finite).sum(dim=-1)                 # (nch,)
    clean = torch.where(finite, data, 0.0)
    # flatline = peak-to-peak span, not variance: an exactly-constant
    # channel has ptp == 0.0 bit-for-bit
    ptp = clean.amax(dim=-1) - clean.amin(dim=-1)
    dead = ptp <= flatline_var
    if clip_limit > 0:
        # the mean of a boolean as jnp.mean takes it: the count divided by
        # nt in the data's floating dtype (float64 under x64), so the >=
        # below rounds alike.  The divisor is a full tensor: PyTorch
        # multiplies by the reciprocal when it divides by a scalar.
        mean_dtype = data.dtype if data.is_floating_point() else torch.float64
        count = ((clean.abs() >= clip_limit) & finite).sum(dim=-1).to(mean_dtype)
        clip_frac = count / torch.full_like(count, data.shape[-1])
        clipped = clip_frac >= clip_fraction_max
    else:
        clipped = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    healthy = (n_nonfinite == 0) & ~dead & ~clipped
    bad = ~healthy
    masked = torch.where(bad[:, None], 0.0, clean)
    if impute:
        # neighbor SUM (edge channels copy the single neighbor); a bad
        # channel whose neighbors are also bad imputes zeros, which the
        # mask-aware normalizations downstream treat as absent
        masked = impute_traces(masked, bad)
    return masked, healthy, n_nonfinite, clipped.sum(), dead.sum()


def screen_arrays(data, cfg: HealthConfig, tag: str = "direct"
                  ) -> Tuple[torch.Tensor, ChannelHealth]:
    """Screen one (nch, nt) waterfall (a tensor on any device, or a numpy
    array, taken as a CPU tensor); returns (sanitized on the same device,
    verdict on the host), counted under ``tag`` in :data:`SCREENS_BY_TAG`."""
    data = torch.as_tensor(data)
    _count_screen(tag)
    out, healthy, n_nonfinite, n_clipped, n_dead = _screen(
        data, float(cfg.flatline_var), float(cfg.clip_limit),
        float(cfg.clip_fraction_max), bool(cfg.impute))
    n_nonfinite = n_nonfinite.cpu().numpy()
    nt = max(int(data.shape[-1]), 1)
    health = ChannelHealth(
        healthy=healthy.cpu().numpy(),
        nan_fraction=float(n_nonfinite.sum()) / (n_nonfinite.size * nt),
        n_nonfinite_channels=int(np.count_nonzero(n_nonfinite)),
        n_dead=int(n_dead), n_clipped=int(n_clipped))
    return out, health


def screen_section(section: DasSection, cfg: HealthConfig,
                   tag: str = "direct") -> Tuple[DasSection, ChannelHealth]:
    """:func:`screen_arrays` on a :class:`DasSection` (axes pass through)."""
    data, health = screen_arrays(section.data, cfg, tag=tag)
    return DasSection(data, section.x, section.t), health


def quick_screen(data: np.ndarray, cfg: HealthConfig) -> ChannelHealth:
    """Host-side (numpy, no device work) screen for serve admission: the
    same per-channel rules as :func:`screen_arrays`, verdict only."""
    data = np.asarray(data)
    finite = np.isfinite(data)
    n_nonfinite = np.sum(~finite, axis=-1)
    clean = np.where(finite, data, 0.0)
    dead = np.ptp(clean, axis=-1) <= cfg.flatline_var   # same rule as _screen
    if cfg.clip_limit > 0:
        clip_frac = np.mean((np.abs(clean) >= cfg.clip_limit) & finite,
                            axis=-1)
        clipped = clip_frac >= cfg.clip_fraction_max
    else:
        clipped = np.zeros(data.shape[0], bool)
    healthy = (n_nonfinite == 0) & ~dead & ~clipped
    nt = max(int(data.shape[-1]), 1)
    return ChannelHealth(
        healthy=healthy,
        nan_fraction=float(n_nonfinite.sum()) / (n_nonfinite.size * nt),
        n_nonfinite_channels=int(np.count_nonzero(n_nonfinite)),
        n_dead=int(np.count_nonzero(dead)),
        n_clipped=int(np.count_nonzero(clipped)))


def admission_verdict(health: ChannelHealth,
                      cfg: HealthConfig) -> Optional[str]:
    """Serve-admission poison rule: a rejection reason, or None to admit.

    Stricter than the batch path's :meth:`ChannelHealth.ok` on purpose —
    batch chunks degrade (mask + continue) because the data is already on
    disk; a served request can be fixed and resubmitted by its caller, so
    ANY non-finite content beyond ``nan_fraction_max`` is shed."""
    if health.nan_fraction > cfg.nan_fraction_max:
        return (f"non-finite sample fraction {health.nan_fraction:.4f} "
                f"exceeds the admission bound {cfg.nan_fraction_max}")
    if not health.ok(cfg):
        return (f"{health.n_masked}/{health.n_channels} channels unhealthy "
                f"(dead={health.n_dead}, clipped={health.n_clipped}) — over "
                f"the max_masked_fraction={cfg.max_masked_fraction} bound")
    return None
