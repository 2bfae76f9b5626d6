"""Array containers of the per-chunk path, as dataclasses of tensors.

Mirrors ``das_diff_veh_tpu/core/section.py``.  The containers are inert; all
compute lives in plain functions.  ``DasSection.x``/``.t`` are host metadata
(float64 CPU tensors), as the JAX loaders keep them host-resident; only
``data`` rides the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class DasSection:
    """One (nch, nt) DAS waterfall with its axes: ``x`` is distance along
    the fiber [m], ``t`` time [s]."""

    data: torch.Tensor     # (nch, nt)
    x: torch.Tensor        # (nch,)
    t: torch.Tensor        # (nt,)

    @property
    def nch(self) -> int:
        return self.data.shape[0]

    @property
    def nt(self) -> int:
        return self.data.shape[-1]

    @property
    def dx(self) -> float:
        return float(self.x[1] - self.x[0])

    @property
    def dt(self) -> float:
        return float(self.t[1] - self.t[0])

    def to(self, device=None, dtype=None) -> "DasSection":
        """Move ``data`` (only) to ``device`` and/or cast it to ``dtype``."""
        return DasSection(self.data.to(device=device, dtype=dtype), self.x, self.t)


@dataclass
class VehicleTracks:
    """Tracked vehicle states on the tracking grid.

    ``t_idx``: (max_vehicles, n_track_ch) float32 arrival-time sample index
    per channel (NaN = no detection).  ``valid``: (max_vehicles,) bool mask of
    live tracks after QC.  ``x``/``t``: tracking-grid axes (1 m / 50 Hz)."""

    t_idx: torch.Tensor    # (max_vehicles, n_track_ch)
    valid: torch.Tensor    # (max_vehicles,)
    x: torch.Tensor        # (n_track_ch,)
    t: torch.Tensor        # (n_track_t,)


@dataclass
class WindowBatch:
    """Fixed-capacity batch of per-vehicle surface-wave windows plus a
    validity mask; trajectories are stored per window on the tracking grid
    (NaN-padded).  ``data`` has the record's dtype; ``x``, ``t`` and
    ``traj_x`` are float64 axes on the same device, ``traj_t`` float32."""

    data: torch.Tensor     # (max_windows, nx, nt_win)
    x: torch.Tensor        # (nx,) common spatial axis
    t: torch.Tensor        # (max_windows, nt_win) absolute time axis per window
    traj_x: torch.Tensor   # (max_windows, n_traj) vehicle position samples [m]
    traj_t: torch.Tensor   # (max_windows, n_traj) vehicle time samples [s] (NaN-padded)
    valid: torch.Tensor    # (max_windows,)

    @property
    def max_windows(self) -> int:
        return self.data.shape[0]
