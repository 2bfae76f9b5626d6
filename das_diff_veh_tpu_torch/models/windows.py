"""Surface-wave window selection and trajectory-aware muting.

Mirrors ``das_diff_veh_tpu/models/windows.py``: selection cuts one
fixed-shape :class:`WindowBatch` with a validity mask; every vehicle slot
yields a window whether accepted or not.  Slice geometry is resolved on the
host from numpy axes.  A ``lax.dynamic_slice`` clamps its start so the slice
fits, so the per-vehicle start is clamped to ``[0, nt - win]`` before the cut.

The window axes (``WindowBatch.t``/``.x``/``.traj_x``) stay float64 whatever
the record's dtype, as the JAX package holds them in its x64 parity runs:
the gather's window starts are comparisons of these axes (``t >= arrival``),
and exact ties are common there (trajectory times are multiples of the
sample interval), so holding them in float32 would flip starts between a
float32 and a float64 run.  ``traj_t`` is float32, as in JAX, since it comes
from the float32 tracks.  ``WindowBatch.x`` is the shared per-geometry
tensor of ``core.constants``, never written.
"""

from __future__ import annotations

import numpy as np
import torch

from das_diff_veh_tpu_torch.config import MuteConfig, WindowConfig
from das_diff_veh_tpu_torch.core.constants import host_constant
from das_diff_veh_tpu_torch.core.section import VehicleTracks, WindowBatch
from das_diff_veh_tpu_torch.ops.filters import tukey_window
from das_diff_veh_tpu_torch.ops.interp import masked_interp


def traj_mute_mask(x_axis: torch.Tensor, t_axis: torch.Tensor,
                   traj_x: torch.Tensor, traj_t: torch.Tensor,
                   traj_valid: torch.Tensor, dx: float,
                   offset: float = 200.0, alpha: float = 0.3,
                   delta_x: float = 20.0,
                   double_sided: bool = False) -> torch.Tensor:
    """(..., nx, nt) multiplicative mute mask following the vehicle
    trajectory: per time sample an ``int(offset/dx)``-sample Tukey window
    whose center tracks the interpolated car position (off-center by
    ``-offset/2 + delta_x`` single-sided), zero outside the taper.  The
    reference's ``argmax(x_axis > center)`` center pick is kept, including
    its all-False -> 0 behavior.  ``t_axis`` (..., nt) and the trajectory
    (..., n_traj) may carry leading window dimensions."""
    n_samp = int(offset / dx)
    w = tukey_window(n_samp, alpha, dtype=t_axis.dtype, device=t_axis.device)
    car_x = masked_interp(t_axis, traj_t, traj_x, traj_valid)     # (..., nt)
    center = car_x if double_sided else car_x - offset / 2.0 + delta_x
    above = (x_axis[:, None] > center[..., None, :]).to(torch.int8)
    center_idx = torch.argmax(above, dim=-2)                      # first True, else 0
    j = (torch.arange(x_axis.shape[0], device=x_axis.device)[:, None]
         - (center_idx[..., None, :] - n_samp // 2))
    inside = (j >= 0) & (j < n_samp)
    return torch.where(inside, w[j.clamp(0, n_samp - 1)], 0.0)


def mute_along_traj(data: torch.Tensor, x_axis: torch.Tensor, t_axis: torch.Tensor,
                    traj_x: torch.Tensor, traj_t: torch.Tensor,
                    traj_valid: torch.Tensor, dx: float,
                    cfg: MuteConfig = MuteConfig(),
                    double_sided: bool = False) -> torch.Tensor:
    """Apply the trajectory mute (:func:`traj_mute_mask`, cast to the data's
    dtype)."""
    alpha = cfg.alpha_double if double_sided else cfg.alpha
    mask = traj_mute_mask(x_axis, t_axis, traj_x, traj_t, traj_valid, dx,
                          offset=cfg.offset, alpha=alpha,
                          delta_x=cfg.delta_x, double_sided=double_sided)
    return data * mask.to(data.dtype)


def mute_along_time(data: torch.Tensor, alpha: float = 0.3) -> torch.Tensor:
    """Temporal Tukey mute along the last axis."""
    return data * tukey_window(data.shape[-1], alpha, dtype=data.dtype, device=data.device)


def window_x_bounds(x: np.ndarray, x0: float,
                    cfg: WindowConfig = WindowConfig()) -> tuple:
    """Host ``(start_x_idx, end_x_idx)`` of the window aperture around pivot
    ``x0`` (end exclusive)."""
    x = np.asarray(x)
    start_x = x0 - cfg.length_sw * cfg.spatial_ratio
    end_x = start_x + cfg.length_sw
    return (int(np.abs(start_x - x).argmin()),
            int(np.abs(end_x - x).argmin()))


def window_x_slice(x: np.ndarray, x0: float,
                   cfg: WindowConfig = WindowConfig()) -> np.ndarray:
    """Host copy of the ``WindowBatch.x`` axis :func:`select_windows` produces."""
    start_x_idx, end_x_idx = window_x_bounds(x, x0, cfg)
    return np.asarray(x)[start_x_idx:end_x_idx]


def select_windows(data: torch.Tensor, x: np.ndarray, t: np.ndarray,
                   tracks: VehicleTracks, x0: float,
                   cfg: WindowConfig = WindowConfig(), *,
                   track_x: np.ndarray = None,
                   track_t: np.ndarray = None) -> WindowBatch:
    """Cut one fixed-shape window batch around each tracked vehicle's arrival
    at pivot ``x0``.

    A slot is valid when the vehicle's state at ``x0`` is finite, it is
    isolated from the list-adjacent vehicles with a finite arrival at ``x0``
    by at least ``temporal_spacing``, and its +-wlen/2 cut fits the record.
    ``x``/``t`` (and ``track_x``/``track_t``, host copies of the tracking
    grid) are host numpy."""
    x = np.asarray(x)
    t = np.asarray(t)
    dev = data.device
    dt = float(t[1] - t[0])
    win_nsamp = int(cfg.wlen_sw / dt)
    spacing = cfg.temporal_spacing if cfg.temporal_spacing else cfg.wlen_sw

    start_x_idx, end_x_idx = window_x_bounds(x, x0, cfg)

    x_track = np.asarray(tracks.x.cpu() if track_x is None else track_x)
    t_track = np.asarray(tracks.t.cpu() if track_t is None else track_t)
    x0_track_idx = int(np.abs(x_track - x0).argmin())
    dt_track = float(t_track[1] - t_track[0])
    t_track0 = float(t_track[0])
    nt = t.shape[0]

    t_idx = tracks.t_idx                                  # (nveh, n_track_ch) float32
    raw = t_idx[:, x0_track_idx]
    finite = torch.isfinite(raw)
    # int(v[x0_idx]) truncation, then the tracking time-axis lookup
    t0_i = torch.clamp(torch.floor(torch.where(finite, raw, 0.0)), 0, t_track.shape[0] - 1)
    t0 = t_track0 + t0_i * dt_track                       # float32, as in JAX

    valid = tracks.valid & finite

    # isolation against the list-adjacent vehicles, skipping neighbors without
    # a finite arrival at x0; the gaps are float64 (JAX promotes them so under
    # x64), which keeps the decision the same on both devices
    t0d = t0.double()
    zero = torch.zeros(1, dtype=torch.float64, device=dev)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    t0_next = torch.cat([t0d[1:], zero])
    next_finite = torch.cat([finite[1:], no])
    t0_prev = torch.cat([zero, t0d[:-1]])
    prev_finite = torch.cat([no, finite[:-1]])
    reject_next = next_finite & ((t0_next - t0d) < spacing)
    gap_prev = t0d - t0_prev
    reject_prev = prev_finite & (gap_prev >= 0) & (gap_prev < spacing)
    valid = valid & ~reject_next & ~reject_prev

    # boundary test on the surface-wave grid (round half to even, as jnp)
    t0_sw_idx = torch.clamp(torch.round((t0d - float(t[0])) / dt).to(torch.int32), 0, nt - 1)
    valid = valid & (t0_sw_idx >= win_nsamp // 2) & (t0_sw_idx + win_nsamp // 2 <= nt)

    start_t_idx = torch.clamp(t0_sw_idx - win_nsamp // 2, 0, nt - win_nsamp).long()
    sub = data[start_x_idx:end_x_idx]
    # (nx, nt - win + 1, win) view; pick each slot's start
    win_data = sub.unfold(-1, win_nsamp, 1)[:, start_t_idx].permute(1, 0, 2).contiguous()
    idx = start_t_idx[:, None] + torch.arange(win_nsamp, device=dev)[None, :]
    win_t = float(t[0]) + idx.double() * dt

    # trajectory in physical coordinates, floor-quantized to the tracking grid
    traj_t = t_track0 + torch.floor(t_idx) * dt_track     # float32, NaN-preserving
    xt = host_constant(x_track, torch.float64, dev)
    traj_x = xt.expand(t_idx.shape).contiguous()

    return WindowBatch(data=win_data,
                       x=host_constant(x[start_x_idx:end_x_idx], torch.float64, dev),
                       t=win_t, traj_x=traj_x, traj_t=traj_t, valid=valid)
