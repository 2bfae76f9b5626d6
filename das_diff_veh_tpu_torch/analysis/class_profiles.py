"""Per-class quasi-static time series and PSD profiles (mirrors
``das_diff_veh_tpu/analysis/class_profiles.py``; imaging_diff_speed.ipynb
cells 5, 11 and 16-18)."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from das_diff_veh_tpu_torch.core.section import WindowBatch
from das_diff_veh_tpu_torch.ops.filters import detrend_linear
from das_diff_veh_tpu_torch.ops.psd import welch_psd
from das_diff_veh_tpu_torch.ops.savgol import savgol_filter


def quasi_static_signatures(qs_batch: WindowBatch, sg_window: int = 101,
                            sg_order: int = 3) -> torch.Tensor:
    """Per-window quasi-static signature (nwin, nt): channel mean ->
    SG(101,3) -> linear detrend -> re-zero at the first sample; NaN rows for
    invalid windows."""
    m = torch.mean(qs_batch.data, dim=1)
    d = detrend_linear(savgol_filter(m, sg_window, sg_order, axis=-1))
    sig = d - d[:, :1]
    return torch.where(qs_batch.valid[:, None], sig, torch.full_like(sig, torch.nan))


def class_timeseries_stats(signatures, class_masks: Mapping[str, np.ndarray]
                           ) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-class (mean, std, 95 % CI) over the vehicle axis of the signature
    traces (imaging_diff_speed.ipynb cell 11); NaN arrays for empty classes,
    a NaN CI for one member."""
    sig = np.asarray(signatures.cpu() if isinstance(signatures, torch.Tensor) else signatures)
    out = {}
    for name, mask in class_masks.items():
        mask = np.asarray(mask, dtype=bool)
        rows = sig[mask]
        rows = rows[np.isfinite(rows).all(axis=-1)] if rows.size else rows
        if rows.shape[0] == 0:
            nanrow = np.full(sig.shape[-1], np.nan)
            out[name] = (nanrow, nanrow.copy(), nanrow.copy())
            continue
        mean = rows.mean(axis=0)
        std = rows.std(axis=0)
        if rows.shape[0] > 1:
            ci = 1.96 * rows.std(axis=0, ddof=1) / np.sqrt(rows.shape[0])
        else:
            ci = np.full(sig.shape[-1], np.nan)
        out[name] = (mean, std, ci)
    return out


def class_psd(window_data, class_masks: Mapping[str, np.ndarray], fs: float,
              nperseg: int = 2048, device=None):
    """Per-class Welch PSD profile (imaging_diff_speed.ipynb cells 16-18):
    PSD per channel per window, mean over channels, then the class average
    over its finite windows.  ``window_data``: (nwin, nch, nt), a tensor on
    its device or numpy sent to ``device`` (``None`` = the card).  Returns
    ``(freqs, {name: (avg, per_window)})`` as host arrays."""
    freqs, p = welch_psd(window_data, fs, nperseg=nperseg, device=device)
    per_window = torch.mean(p, dim=1).cpu().numpy()
    finite = np.isfinite(per_window).all(axis=-1)
    out = {}
    for name, mask in class_masks.items():
        rows = per_window[np.asarray(mask, dtype=bool) & finite]
        if rows.shape[0] == 0:
            out[name] = (np.full(freqs.shape, np.nan), rows)
        else:
            out[name] = (rows.mean(axis=0), rows)
    return freqs, out
