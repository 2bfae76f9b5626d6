"""Vehicle speed and weight classification (mirrors
``das_diff_veh_tpu/analysis/classify.py``; imaging_diff_speed.ipynb cells
5-8 and imaging_diff_weight.ipynb cells 5-8).  The speeds are a masked
least-squares slope on the device; the class splits are numpy on the host."""

from __future__ import annotations

import numpy as np
import torch

from das_diff_veh_tpu_torch.core.section import VehicleTracks, WindowBatch


def vehicle_speeds(tracks: VehicleTracks) -> torch.Tensor:
    """Per-vehicle speed [m/s]: the least-squares slope of arrival time
    against position over each track's finite samples (NaN where the slope
    vanishes), on the tracks' device."""
    x = tracks.x
    wdt = torch.promote_types(torch.promote_types(tracks.t_idx.dtype, tracks.t.dtype), x.dtype)
    x = x.to(wdt)
    dt_track = (tracks.t[1] - tracks.t[0]).to(wdt)
    rows = tracks.t_idx
    valid = torch.isfinite(rows)
    zero = torch.zeros((), dtype=wdt, device=x.device)
    n = torch.clamp(valid.sum(-1).to(wdt), min=2.0)
    t_s = torch.where(valid, rows.to(wdt), zero) * dt_track
    xm = torch.sum(torch.where(valid, x, zero), dim=-1) / n
    tm = torch.sum(t_s, dim=-1) / n
    dx_ = x - xm[:, None]
    cov = torch.sum(torch.where(valid, dx_ * (t_s - tm[:, None]), zero), dim=-1)
    var = torch.sum(torch.where(valid, dx_ ** 2, zero), dim=-1)
    slowness = cov / torch.where(var > 0, var, torch.ones_like(var))
    return torch.where(torch.abs(slowness) > 1e-9, 1.0 / torch.abs(slowness),
                       torch.full_like(slowness, torch.nan))


def quasi_static_peaks(qs_batch: WindowBatch, sg_window: int = 101,
                       sg_order: int = 3) -> torch.Tensor:
    """max |quasi-static signature| per window (imaging_diff_speed.ipynb cell
    5); NaN for invalid windows."""
    from das_diff_veh_tpu_torch.analysis.class_profiles import quasi_static_signatures

    sig = quasi_static_signatures(qs_batch, sg_window=sg_window, sg_order=sg_order)
    return torch.amax(torch.abs(sig), dim=-1)


def _hist_mode(values: np.ndarray, bins: int = 100) -> float:
    hist, edges = np.histogram(values, bins=bins)
    return float(edges[int(np.argmax(hist))])


def majority_weight_mask(peaks, frac_sigma: float = 0.3, bins: int = 100) -> np.ndarray:
    """Peaks within ±frac_sigma·std of the histogram mode
    (imaging_diff_speed.ipynb cell 6); all-False on empty or all-NaN input."""
    peaks = np.asarray(peaks)
    ok = np.isfinite(peaks)
    if not ok.any():
        return ok
    mode = _hist_mode(peaks[ok], bins)
    sigma = float(np.std(peaks[ok]))
    return ok & (peaks >= mode - frac_sigma * sigma) & (peaks <= mode + frac_sigma * sigma)


def majority_speed_mask(speeds, n_sigma: float = 1.0) -> np.ndarray:
    """Speeds within mean ± n_sigma·std (imaging_diff_weight.ipynb cell 5);
    all-False on empty or all-NaN input."""
    speeds = np.asarray(speeds)
    ok = np.isfinite(speeds)
    if not ok.any():
        return ok
    mu, sd = float(np.mean(speeds[ok])), float(np.std(speeds[ok]))
    return ok & (speeds >= mu - n_sigma * sd) & (speeds <= mu + n_sigma * sd)


def classify_by_speed(speeds):
    """fast / mid / slow at mean ± std (imaging_diff_speed.ipynb cell 8)."""
    speeds = np.asarray(speeds)
    ok = np.isfinite(speeds)
    if not ok.any():
        return ok, ok.copy(), ok.copy()
    hi = float(np.mean(speeds[ok]) + np.std(speeds[ok]))
    lo = float(np.mean(speeds[ok]) - np.std(speeds[ok]))
    return ok & (speeds > hi), ok & (speeds <= hi) & (speeds > lo), ok & (speeds <= lo)


def classify_by_weight(peaks, heavy_threshold: float = 1.2, bins: int = 100):
    """heavy / mid / light: > 1.2, (mode, 1.2], <= histogram mode
    (imaging_diff_weight.ipynb cell 8)."""
    peaks = np.asarray(peaks)
    ok = np.isfinite(peaks)
    if not ok.any():
        return ok, ok.copy(), ok.copy()
    mode = _hist_mode(peaks[ok], bins)
    heavy = ok & (peaks > heavy_threshold)
    mid = ok & (peaks <= heavy_threshold) & (peaks > mode)
    light = ok & (peaks <= mode)
    return heavy, mid, light
