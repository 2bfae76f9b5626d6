"""Classed vehicle analysis: the imaging_diff_{speed,weight} notebook flow
as one driver (mirrors ``das_diff_veh_tpu/analysis/classed.py``).

Per-vehicle quasi-static peak -> majority filter on the *other* attribute
-> three classes -> per-class time-series stats and averaged Welch PSD.
Window-batch rows map 1:1 to tracked vehicles, so speeds (from the tracks)
and weights (from the raw-band windows) align by row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from das_diff_veh_tpu_torch.analysis import classify as C
from das_diff_veh_tpu_torch.analysis.class_profiles import (class_psd,
                                                            class_timeseries_stats,
                                                            quasi_static_signatures)
from das_diff_veh_tpu_torch.core.section import VehicleTracks, WindowBatch


@dataclass
class ClassedAnalysis:
    """Per-class masks + profiles for one chunk's vehicles (host arrays)."""

    masks: Dict[str, np.ndarray]
    majority: np.ndarray
    speeds: np.ndarray
    peaks: np.ndarray
    signatures: np.ndarray
    ts_stats: Mapping[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]
    psd_freqs: np.ndarray
    psd: Mapping[str, Tuple[np.ndarray, np.ndarray]]


def classed_analysis(qs_batch: WindowBatch, tracks: VehicleTracks, *, by: str = "speed",
                     fs: float = 250.0, nperseg: int = 2048,
                     heavy_threshold: float = 1.2) -> ClassedAnalysis:
    """The classed-analysis flow on one chunk's raw-band windows and tracks
    (``process_chunk(..., with_qs=True)``), on their device.  ``by="speed"``:
    majority-weight filter, then fast/mid/slow; ``by="weight"``:
    majority-speed filter, then heavy/mid/light."""
    if by not in ("speed", "weight"):
        raise ValueError(f"by must be 'speed' or 'weight', got {by!r}")
    sig = quasi_static_signatures(qs_batch)
    peaks = torch.amax(torch.abs(sig), dim=-1).cpu().numpy()
    valid = qs_batch.valid.cpu().numpy()
    speeds = np.where(valid, C.vehicle_speeds(tracks).cpu().numpy(), np.nan)
    if by == "speed":
        majority = C.majority_weight_mask(peaks)
        fast, mid, slow = C.classify_by_speed(np.where(majority, speeds, np.nan))
        masks = {"fast": fast, "mid": mid, "slow": slow}
    else:
        majority = C.majority_speed_mask(speeds)
        heavy, mid, light = C.classify_by_weight(np.where(majority, peaks, np.nan),
                                                 heavy_threshold=heavy_threshold)
        masks = {"heavy": heavy, "mid": mid, "light": light}
    sig_np = sig.cpu().numpy()
    ts_stats = class_timeseries_stats(sig_np, masks)
    freqs, psd = class_psd(qs_batch.data, masks, fs,
                           nperseg=min(nperseg, qs_batch.data.shape[-1]))
    return ClassedAnalysis(masks=masks, majority=np.asarray(majority), speeds=speeds,
                           peaks=peaks, signatures=sig_np, ts_stats=ts_stats,
                           psd_freqs=np.asarray(freqs), psd=psd)


def class_stacks(per_window: torch.Tensor, valid, masks: Mapping[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
    """Masked-mean stack of any per-window tensor per class (the aggregation
    inside the reference's ``save_disp_imgs``)."""
    from das_diff_veh_tpu_torch.models.vsg import stack_gathers

    dev = per_window.device
    valid = torch.as_tensor(valid).to(dev)
    return {name: stack_gathers(per_window, valid & torch.as_tensor(mask).to(dev))
            for name, mask in masks.items()}
