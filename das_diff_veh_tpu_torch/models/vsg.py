"""Virtual-shot-gather interferometry.

Mirrors ``das_diff_veh_tpu/models/vsg.py``: each per-vehicle window becomes a
virtual shot gather at a pivot channel.

- channels behind the vehicle correlate against the pivot over one fixed
  window anchored ``delta_t`` after the vehicle's pivot arrival;
- channels between pivot and vehicle use per-channel windows that follow the
  trajectory (``ops.xcorr.xcorr_traj_follow``);
- the mirrored other side runs time-reversed windows ahead of the vehicle and
  is averaged in where nonzero.

Channel geometry is resolved on the host into a :class:`VsgGeometry`.  Where
JAX vmaps ``build_gather`` over the window slots, here the slot axis is a
batch dimension carried through, so each trajectory side is one call of the
gather kernel for all slots: two launches per chunk.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from das_diff_veh_tpu_torch.config import DispersionConfig, GatherConfig
from das_diff_veh_tpu_torch.core.section import WindowBatch
from das_diff_veh_tpu_torch.ops import xcorr as xc
from das_diff_veh_tpu_torch.ops.dispersion import fv_map_fk, fv_map_phase_shift
from das_diff_veh_tpu_torch.ops.interp import masked_interp


@dataclass(frozen=True)
class VsgGeometry:
    """Static channel/time geometry of one gather configuration, resolved on
    the host (the window batch shares its x/t axes)."""

    start_x_idx: int       # argmax(x >= start_x)
    end_x_idx: int         # argmin(|x - end_x|)
    pivot_idx: int         # argmax(x >= pivot)
    pivot_x: float         # the requested pivot coordinate (arrival is
                           # interpolated here, not at the snapped channel)
    nsamp: int             # int(time_window // dt)
    wlen: int              # int(wlen / dt)  correlation window [samples]
    dt: float

    @property
    def nch_out(self) -> int:
        return self.end_x_idx - self.start_x_idx

    @classmethod
    def build(cls, x_axis: np.ndarray, dt: float, pivot: float,
              start_x: float, end_x: float, cfg: GatherConfig) -> "VsgGeometry":
        x = np.asarray(x_axis)
        return cls(
            start_x_idx=int(np.argmax(x >= start_x)),
            end_x_idx=int(np.abs(x - end_x).argmin()),
            pivot_idx=int(np.argmax(x >= pivot)),
            pivot_x=float(pivot),
            nsamp=int(cfg.time_window // dt),
            wlen=int(cfg.wlen / dt),
            dt=float(dt),
        )

    def offsets(self, x_axis: np.ndarray) -> np.ndarray:
        """Output x axis: offsets re-zeroed at the pivot."""
        x = np.asarray(x_axis)
        return x[self.start_x_idx:self.end_x_idx] - x[self.pivot_idx]

    def lags(self) -> np.ndarray:
        """Output lag-time axis, zero lag centered."""
        return (np.arange(self.wlen) - self.wlen // 2) * self.dt


def _postprocess(xcf: torch.Tensor, g: VsgGeometry, norm: bool, norm_amp: bool,
                 reverse: bool) -> torch.Tensor:
    """Per-trace L2 norm, amplitude norm by the pivot trace's max, and a
    lag-axis flip on the main side, on (..., nch_out, wlen).  Zero rows divide
    by 1 instead of 0/0."""
    if norm:
        rn = torch.linalg.vector_norm(xcf, dim=-1, keepdim=True)
        xcf = xcf / torch.where(rn > 0, rn, 1.0)
    if norm_amp:
        amp = torch.amax(xcf[..., g.pivot_idx - g.start_x_idx, :], dim=-1)
        xcf = xcf / torch.where(torch.abs(amp) > 0, amp, 1.0)[..., None, None]
    if not reverse:
        xcf = xcf.flip(-1)
    return xcf


def build_gather(data: torch.Tensor, t_axis: torch.Tensor, x_axis: torch.Tensor,
                 traj_x: torch.Tensor, traj_t: torch.Tensor,
                 traj_valid: torch.Tensor, g: VsgGeometry,
                 cfg: GatherConfig = GatherConfig()) -> torch.Tensor:
    """Window(s) -> virtual shot gather(s) (*lead, nch_out, wlen).

    ``data`` (*lead, nx, nt), ``t_axis`` (*lead, nt), ``x_axis`` (nx,),
    trajectories (*lead, n_traj).  Includes the other-side merge when
    ``cfg.include_other_side``."""
    arrival = lambda xq: masked_interp(xq, traj_x, traj_t, traj_valid)
    gn = torch.linalg.vector_norm(data, dim=(-2, -1), keepdim=True)   # global L2
    d = data / torch.where(gn > 0, gn, 1.0)              # all-zero (padded) windows stay 0
    x = x_axis
    pv, sx, ex = g.pivot_idx, g.start_x_idx, g.end_x_idx
    kw = dict(overlap_ratio=cfg.overlap_ratio, mode=cfg.traj_gather,
              finish=cfg.traj_gather_finish, max_nwin=cfg.fused_max_nwin,
              dot_max_wlen=cfg.dot_max_wlen, dot_max_elems=cfg.dot_max_matrix_elems,
              precision=cfg.precision)
    pivot_arrival = arrival(torch.full((1,), g.pivot_x, dtype=x.dtype,
                                       device=x.device))[..., 0]

    def first_at_or_after(t_q):
        # argmax of a boolean is the first True (0 when none): cast first
        return torch.argmax((t_axis >= t_q[..., None]).to(torch.int8), dim=-1)

    # ---- main side (behind the vehicle) --------------------------------------
    pivot_t_idx = first_at_or_after(pivot_arrival + cfg.delta_t)
    near = xc.xcorr_vshot_at(d[..., sx:pv + 1, :], pv - sx, pivot_t_idx,
                             g.nsamp, g.wlen, cfg.overlap_ratio)
    far_ch = torch.arange(pv + 1, ex, device=data.device)
    far = xc.xcorr_traj_follow(d, t_axis, pv, far_ch, arrival(x[far_ch]) + cfg.delta_t,
                               g.nsamp, g.wlen, **kw)
    main = _postprocess(torch.cat([near, far], dim=-2), g, cfg.norm, cfg.norm_amp,
                        reverse=False)
    if not cfg.include_other_side:
        return main

    # ---- other side (ahead of the vehicle, time-reversed windows) ------------
    pivot_t2_idx = first_at_or_after(pivot_arrival - cfg.delta_t)
    right = xc.xcorr_vshot_at(d[..., pv:ex, :], 0, pivot_t2_idx, g.nsamp, g.wlen,
                              cfg.overlap_ratio, reverse=True, backward=True)
    left_ch = torch.arange(sx, pv, device=data.device)
    left = xc.xcorr_traj_follow(d, t_axis, pv, left_ch, arrival(x[left_ch]) - cfg.delta_t,
                                g.nsamp, g.wlen, reverse=True, **kw)
    other = _postprocess(torch.cat([left, right], dim=-2), g, cfg.norm, cfg.norm_amp,
                         reverse=True)
    # average in other-side rows where they are nonzero
    has_other = torch.linalg.vector_norm(other, dim=-1, keepdim=True) > 0
    return torch.where(has_other, 0.5 * (main + other), main)


def build_gather_batch(batch: WindowBatch, g: VsgGeometry,
                       cfg: GatherConfig = GatherConfig()) -> torch.Tensor:
    """:func:`build_gather` over the whole window batch at once:
    (max_windows, nch_out, wlen)."""
    return build_gather(batch.data, batch.t, batch.x, batch.traj_x, batch.traj_t,
                        torch.isfinite(batch.traj_t), g, cfg)


def stack_gathers(gathers: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked mean over the window axis; ``where``-masked so a NaN in an
    invalid slot cannot leak through."""
    mask = valid.reshape(valid.shape + (1,) * (gathers.ndim - 1))
    num = torch.sum(torch.where(mask, gathers, 0.0), dim=0)
    return num / torch.clamp(valid.to(gathers.dtype).sum(), min=1.0)


def gather_disp_image(xcf: torch.Tensor, offsets: np.ndarray, dt: float,
                      dx: float, cfg: DispersionConfig = DispersionConfig(),
                      start_x: float | None = None,
                      end_x: float | None = None) -> torch.Tensor:
    """Dispersion image of (a stack of) gathers over an offset sub-range:
    (nvel, nfreq).  ``cfg.method``: ``"fk"`` (2-D FFT) or ``"phase_shift"``
    (slant stack, direction -1: the gather's offsets ascend toward the
    virtual source at 0); both honour ``cfg.precision``."""
    offsets = np.asarray(offsets)
    sxi = int(np.abs(offsets - (start_x if start_x is not None else offsets[0])).argmin())
    exi = int(np.abs(offsets - (end_x if end_x is not None else offsets[-1])).argmin())
    sliced = xcf[..., sxi:exi + 1, :]
    if cfg.method == "phase_shift":
        return fv_map_phase_shift(sliced, dx, dt, cfg.freqs(), cfg.vels(), direction=-1.0,
                                  whiten=False, precision=cfg.precision)
    return fv_map_fk(sliced, dx, dt, cfg.freqs(), cfg.vels(), norm=cfg.norm,
                     sg_window=cfg.sg_window, sg_order=cfg.sg_order, precision=cfg.precision)
