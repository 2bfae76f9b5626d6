"""Kalman-filter vehicle tracking on the quasi-static band.

Mirrors ``das_diff_veh_tpu/models/tracking.py``: peaks are detected for every
strided channel as one batch, then a 2-state [arrival-time sample index,
slowness] Kalman filter marches along the strided channels, one Python loop
step per channel (the JAX ``lax.scan``), vectorized over the vehicle slots.
The filter state is float32 whatever the data's dtype, as in the JAX package
(its state arrays are created float32 and stay so under x64).  The host axes
and step indices reach the device once per geometry (``core.constants``);
``VehicleTracks.x``/``.t`` are those shared tensors, never written.
"""

from __future__ import annotations

import numpy as np
import torch

from das_diff_veh_tpu_torch.config import TrackingConfig, TrackQCConfig
from das_diff_veh_tpu_torch.core.constants import host_constant
from das_diff_veh_tpu_torch.core.section import VehicleTracks
from das_diff_veh_tpu_torch.ops.interp import masked_interp_clamped
from das_diff_veh_tpu_torch.ops.peaks import find_peaks, gaussian_likelihood

_F32 = torch.float32


def detect_vehicle_base(data: torch.Tensor, t_axis: torch.Tensor,
                        start_x_idx: int, cfg: TrackingConfig = TrackingConfig()):
    """Stacked-likelihood vehicle arrival detection over ``n_detect_channels``
    consecutive channels from ``start_x_idx`` (clamped so the rows fit, like
    ``lax.dynamic_slice``).  Returns (base (max_vehicles,) int32, valid)."""
    det = cfg.detect
    n = cfg.n_detect_channels
    s = min(max(int(start_x_idx), 0), data.shape[0] - n)
    rows = data[s:s + n]
    pk_pos, pk_valid = find_peaks(rows, det.min_prominence, det.min_separation,
                                  det.prominence_wlen, det.max_peaks)
    like = gaussian_likelihood(pk_pos, pk_valid, t_axis, cfg.likelihood_sigma)
    stacked = torch.sum(like, dim=0)
    # find_peaks(height=0, distance=minseparation): local maxima + distance only
    return find_peaks(stacked, min_distance=det.min_separation,
                      max_peaks=cfg.max_vehicles, use_prominence=False)


def _associate(pk_pos, pk_valid, pred, gate_lo, gate_hi, bug_compat=True):
    """Data association of every vehicle slot against one channel's peaks:
    inside the asymmetric gate prefer a positive lag, else the smallest
    absolute lag; NaN when the gate is empty.  ``bug_compat=True`` records the
    first gated peak when a positive lag exists (the reference's
    subset-indexing slip).  ``pred`` (nveh,), peaks (npk,) -> (nveh,)."""
    dist = pk_pos.to(_F32)[None, :] - pred[:, None]            # (nveh, npk)
    in_gate = pk_valid[None, :] & (dist > gate_lo) & (dist <= gate_hi)
    pos = in_gate & (dist > 0)
    # argmax/argmin return the first extreme index, as jnp's do
    i_pos = (torch.argmax(in_gate.to(torch.int8), dim=-1) if bug_compat
             else torch.argmin(torch.where(pos, dist, torch.inf), dim=-1))
    i_abs = torch.argmin(torch.where(in_gate, torch.abs(dist), torch.inf), dim=-1)
    choice = torch.where(pos.any(-1), i_pos, i_abs)
    return torch.where(in_gate.any(-1), pk_pos[choice].to(pred.dtype), torch.nan)


def track_vehicles(data: torch.Tensor, x_axis, start_x: float,
                   end_x: float, base: torch.Tensor, base_valid: torch.Tensor,
                   cfg: TrackingConfig = TrackingConfig()):
    """March the per-vehicle Kalman filter along strided channels.

    ``x_axis`` is host metadata.  Returns ``(veh_states (max_vehicles,
    n_steps) float32 recorded arrival sample index per strided channel, NaN
    where unassociated; step_x (n_steps,) numpy)``."""
    x_axis = np.asarray(x_axis)
    start_x_idx = int(np.abs(start_x - x_axis).argmin())
    end_x_idx = int(np.abs(end_x - x_axis).argmin())
    step_idx = np.arange(start_x_idx, end_x_idx + 1, cfg.channel_stride)
    step_x = x_axis[step_idx]
    det = cfg.detect
    nveh = base.shape[0]
    dev = data.device

    pk_pos, pk_valid = find_peaks(data[host_constant(step_idx, torch.int64, dev)],
                                  det.min_prominence, det.min_separation,
                                  det.prominence_wlen, det.max_peaks)

    base_f = torch.where(base_valid, base, 0).to(_F32)
    Tkk = torch.zeros((nveh, 2), dtype=_F32, device=dev)
    Pkk = torch.zeros((nveh, 2, 2), dtype=_F32, device=dev)
    Xv = torch.zeros((nveh,), dtype=_F32, device=dev)
    count = torch.zeros((nveh,), dtype=torch.int32, device=dev)
    obs1 = torch.zeros((nveh,), dtype=_F32, device=dev)
    obs1_x = torch.zeros((nveh,), dtype=_F32, device=dev)
    xs = host_constant(step_x, _F32, dev)
    states = []
    for i in range(len(step_idx)):
        x_i = xs[i]
        c0 = count == 0
        c1 = count == 1
        # the count==1 branch persistently re-seeds the state from the single
        # recorded sample
        Tkk = torch.where(c1[:, None],
                          torch.stack([obs1, torch.zeros_like(obs1)], -1), Tkk)
        Pkk = torch.where(c1[:, None, None], 0.0, Pkk)
        Xv = torch.where(c1, obs1_x, Xv)

        dx = x_i - Xv                                             # (nveh,)
        one, zero = torch.ones_like(dx), torch.zeros_like(dx)
        A = torch.stack([torch.stack([one, dx], -1),
                         torch.stack([zero, one], -1)], -2)
        Q = cfg.sigma_a * torch.stack(
            [torch.stack([0.25 * dx ** 4, 0.5 * dx ** 3], -1),
             torch.stack([0.5 * dx ** 3, dx ** 2], -1)], -2)
        Tk1k = torch.einsum("vij,vj->vi", A, Tkk)
        Pk1k = torch.einsum("vij,vjk,vlk->vil", A, Pkk, A) + Q
        pred = torch.where(c0 | c1, base_f, Tk1k[:, 0])

        obs = _associate(pk_pos[i], pk_valid[i], pred, cfg.gate_lo, cfg.gate_hi,
                         cfg.assoc_bug_compat)
        obs = torch.where(base_valid, obs, torch.nan)             # padded slots stay empty
        rec = torch.isfinite(obs)
        count = count + rec.to(torch.int32)

        newly_first = rec & c0
        obs1 = torch.where(newly_first, obs, obs1)
        obs1_x = torch.where(newly_first, x_i, obs1_x)

        do_upd = (count > 2) & rec
        K = Pk1k[:, :, 0] / (cfg.meas_noise + Pk1k[:, 0, 0])[:, None]   # (nveh, 2)
        innov = torch.where(rec, obs - Tk1k[:, 0], 0.0)
        Tkk_new = Tk1k + K * innov[:, None]
        Pkk_new = Pk1k - K[:, :, None] * Pk1k[:, 0:1, :]
        Tkk = torch.where(do_upd[:, None], Tkk_new, Tkk)
        Pkk = torch.where(do_upd[:, None, None], Pkk_new, Pkk)
        Xv = torch.where(do_upd, x_i, Xv)
        states.append(obs)
    return torch.stack(states, dim=-1), step_x                    # (nveh, n_steps)


def _compact(vals: torch.Tensor, valid: torch.Tensor):
    """Stable compaction along the last axis: valid entries first, original
    order preserved."""
    n = vals.shape[-1]
    ar = torch.arange(n, device=vals.device)
    order = torch.argsort(torch.where(valid, ar, n + ar), dim=-1)
    return torch.gather(vals, -1, order), torch.gather(valid, -1, order)


def track_qc(veh_states: torch.Tensor, qc: TrackQCConfig = TrackQCConfig()):
    """Vectorized track sanity rejection on the strided state array, one row
    per vehicle.  Returns ``(veh_states with >max_jump jumps NaN'd, keep
    (nveh,) mask)``; the rejection tests read the pre-jump-masked values."""
    ns = veh_states.shape[-1]
    w = int(qc.retrograde_window)
    dev = veh_states.device
    valid = torch.isfinite(veh_states)
    nv = valid.sum(-1)
    vals, _ = _compact(torch.where(valid, veh_states, 0.0), valid)
    d = vals[..., 1:] - vals[..., :-1]                  # diffs of consecutive valid samples
    nd = nv - 1
    d_ok = torch.arange(ns - 1, device=dev) < nd[:, None]
    # retrograde: any w-diff sliding sum <= threshold ('valid' convolve); with
    # fewer than w diffs the partial sums all equal sum(d): test the total drift
    cs = torch.cat([torch.zeros_like(vals[:, :1]),
                    torch.cumsum(torch.where(d_ok, d, 0.0), dim=-1)], dim=-1)
    win_sum = cs[:, w:] - cs[:, :-w]
    win_ok = torch.arange(win_sum.shape[-1], device=dev) + w <= nd[:, None]
    retro_full = (win_ok & (win_sum <= qc.retrograde_threshold)).any(-1)
    total = torch.gather(cs, -1, nd.clamp(0, ns - 1)[:, None])[:, 0]
    retro_partial = (nd > 0) & (nd < w) & (total <= qc.retrograde_threshold)
    retrograde = retro_full | retro_partial
    # total travel |last - first| against the coverage-scaled minimum; the
    # coverage ratio is a float64 true division, as under JAX's x64
    first = vals[:, 0]
    last = torch.gather(vals, -1, (nv - 1).clamp(min=0)[:, None])[:, 0]
    short = torch.abs(last - first) < qc.min_travel_samples * (nv.double() / ns)
    nanrow = ~valid
    adjacency = (nanrow[:, 1:] & nanrow[:, :-1]).sum(-1)
    reject = ((nv < qc.min_valid_fraction * ns) | retrograde | short |
              (adjacency >= qc.max_adjacent_nan))
    # jump masking: the later sample of any |diff| > max_jump pair -> NaN
    jump = d_ok & (torch.abs(d) > qc.max_jump)
    valid_pos = torch.cumsum(valid.to(torch.int64), dim=-1) - 1   # rank of each valid sample
    jump_padded = torch.cat([torch.zeros_like(jump[:, :1]), jump], dim=-1)
    hit = torch.gather(jump_padded, -1, valid_pos.clamp(0, ns - 1))
    masked = torch.where(valid & hit, torch.nan, veh_states)
    return masked, ~reject


def upsample_tracks(veh_states: torch.Tensor, factor: int, n_out: int) -> torch.Tensor:
    """Spread strided states onto the full channel grid and fill NaNs with
    np.interp semantics: linear inside the valid span, clamped outside."""
    ns = veh_states.shape[-1]
    kw = dict(dtype=veh_states.dtype, device=veh_states.device)
    pos = (torch.arange(ns, **kw) * factor).expand_as(veh_states)
    q = torch.arange(n_out, **kw)
    valid = torch.isfinite(veh_states)
    return masked_interp_clamped(q, pos, torch.where(valid, veh_states, 0.0), valid)


def track_grid(x_axis, start_x: float, end_x: float) -> np.ndarray:
    """Host copy of the [start_x, end_x]-restricted tracking x grid, exactly
    the axis :func:`track_section` returns as ``VehicleTracks.x``."""
    x_axis = np.asarray(x_axis)
    start_x_idx = int(np.abs(start_x - x_axis).argmin())
    end_x_idx = int(np.abs(end_x - x_axis).argmin())
    return x_axis[start_x_idx:end_x_idx + 1]


def track_section(data: torch.Tensor, x_axis, t_axis, start_x: float,
                  end_x: float, cfg: TrackingConfig = TrackingConfig(),
                  qc: TrackQCConfig = TrackQCConfig()) -> VehicleTracks:
    """detect -> Kalman filter -> QC -> upsample: the whole tracking stage on
    the tracking grid restricted to [start_x, end_x].  ``x_axis``/``t_axis``
    are host numpy."""
    x_axis = np.asarray(x_axis)
    t_axis = np.asarray(t_axis)
    start_x_idx = int(np.abs(start_x - x_axis).argmin())
    t_dev = host_constant(t_axis, data.dtype, data.device)
    base, base_valid = detect_vehicle_base(data, t_dev, start_x_idx, cfg)
    states, _ = track_vehicles(data, x_axis, start_x, end_x, base, base_valid, cfg)
    states, keep = track_qc(states, qc)
    grid = track_grid(x_axis, start_x, end_x)
    full = upsample_tracks(states, cfg.channel_stride, grid.shape[0])
    return VehicleTracks(t_idx=full, valid=base_valid & keep,
                         x=host_constant(grid, data.dtype, data.device),
                         t=t_dev)
