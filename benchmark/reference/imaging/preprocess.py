"""Preprocessing stages feeding the tracker and the imaging path.

Mirrors ``das_diff_veh_tpu/pipeline/preprocess.py``:

- surface-wave band: 1.2-30 Hz band-pass, empty/noisy trace imputation,
  optional per-trace L2 norm;
- quasi-static band (tracking): loud-channel kill, imputation, 0.08-1 Hz
  band-pass, 250 -> 50 Hz subsample, 8.16 m -> 1 m polyphase spatial
  resample, spatial wavenumber band-pass.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .config import (InterrogatorConfig,
                                           SurfaceWavePreprocessConfig,
                                           TrackingPreprocessConfig)
from .filters import (bandpass_space, bandpass_time,
                                                l2_normalize_traces, median)
from .qc import (empty_trace_mask, impute_traces,
                                           noisy_trace_mask)
from .resample import resample_poly


def channels_to_distance(x: np.ndarray,
                         interrogator: InterrogatorConfig = InterrogatorConfig()) -> np.ndarray:
    """Channel numbers -> meters along fiber: ``(x - start_ch) * dx``."""
    return (np.asarray(x) - interrogator.start_ch) * interrogator.dx


def preprocess_for_surface_waves(data: torch.Tensor, dt: float,
                                 cfg: SurfaceWavePreprocessConfig = SurfaceWavePreprocessConfig(),
                                 normalize: bool | None = None) -> torch.Tensor:
    """Surface-wave band conditioning.  ``normalize`` overrides
    ``cfg.normalize_traces`` (the xcorr method does not normalize)."""
    out = bandpass_time(data, dt, cfg.flo, cfg.fhi)
    if cfg.impute_empty:
        out = impute_traces(out, empty_trace_mask(out, cfg.noise_threshold))
    if cfg.impute_noisy:
        out = impute_traces(out, noisy_trace_mask(out, cfg.noise_threshold))
    if cfg.normalize_traces if normalize is None else normalize:
        out = l2_normalize_traces(out)
    return out


def preprocess_for_tracking(data: torch.Tensor, x_dist: np.ndarray, dt: float,
                            cfg: TrackingPreprocessConfig = TrackingPreprocessConfig(),
                            dx: float = 8.16):
    """Quasi-static band conditioning for the tracker.

    Returns ``(track_data (n_track_ch, n_track_t), x_track (meters, ~1 m
    grid, host numpy), t_stride)``; the caller slices its time axis with
    ``t_stride``."""
    loud = median(torch.abs(data), dim=-1) > cfg.noise_level
    out = torch.where(loud[:, None], 0.0, data)
    out = impute_traces(out, empty_trace_mask(out, cfg.empty_threshold))
    out = bandpass_time(out, dt, cfg.flo, cfg.fhi)
    out = out[:, ::cfg.subsample]
    # spatial resample dx -> target_dx (8.16 m -> 1 m is 204/25)
    frac = Fraction(dx / cfg.target_dx).limit_denominator(1000)
    out = resample_poly(out, frac.numerator, frac.denominator, axis=0)
    x_track = np.arange(out.shape[0]) * cfg.target_dx + float(np.asarray(x_dist)[0])
    out = bandpass_space(out, cfg.target_dx, cfg.flo_space, cfg.fhi_space)
    return out, x_track, cfg.subsample
