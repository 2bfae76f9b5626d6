"""Bootstrap dispersion uncertainty and the convergence study (mirrors
``das_diff_veh_tpu/analysis/bootstrap.py``).

The reference rebuilds every virtual shot gather for every repetition
(apis/imaging_classes.py:31-36).  Stacking is linear in the per-window
gathers, so each window's gather is computed once and the *stacks* are
resampled: one gather of the index matrix, one mean per repetition, then the
whole repetition batch is imaged in one ``gather_disp_image`` call (it takes
leading dimensions) and ridge-extracted per band.

Two stacking forms, as in the JAX package: the plain mean over each
repetition's windows, and the count-masked sum divided by the count (rows
padded to a common width), which rounds otherwise and which only
:func:`convergence_test` uses.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from das_diff_veh_tpu_torch.analysis.ridge import extract_ridge_batch
from das_diff_veh_tpu_torch.config import BootstrapConfig, DispersionConfig
from das_diff_veh_tpu_torch.device import on_device
from das_diff_veh_tpu_torch.models.vsg import gather_disp_image


def sample_indices(n_windows: int, bt_size: int, bt_times: int, rng: np.random.Generator,
                   exclude_first: bool = True) -> np.ndarray:
    """(bt_times, bt_size) resampling matrix, without replacement per row.

    ``exclude_first`` mirrors the reference's ``random.sample(range(1, n))``
    (apis/imaging_classes.py:32), which never samples window 0."""
    lo = 1 if exclude_first else 0
    if bt_size > n_windows - lo:
        raise ValueError(f"bt_size={bt_size} > available windows {n_windows - lo}")
    return np.stack([rng.choice(np.arange(lo, n_windows), size=bt_size, replace=False)
                     for _ in range(bt_times)])


def _resample_stacks(gathers: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(bt_times, ...) mean stacks of ``gathers[idx[r]]`` per repetition."""
    return torch.mean(gathers[idx], dim=1)


def _resample_stacks_counts(gathers: torch.Tensor, idx: torch.Tensor,
                            counts: torch.Tensor) -> torch.Tensor:
    """Row r averages ``gathers[idx[r, :counts[r]]]``: the padded slots point
    at a valid window and are masked out of the sum."""
    g = gathers[idx]                                            # (bt, width, ...)
    mask = torch.arange(idx.shape[1], device=idx.device)[None, :] < counts[:, None]
    mask = mask.reshape(mask.shape + (1,) * (g.ndim - 2)).to(g.dtype)
    c = counts.to(g.dtype).reshape((-1,) + (1,) * (g.ndim - 2))
    return torch.sum(g * mask, dim=1) / c


def bootstrap_disp(gathers, offsets: np.ndarray, dt: float, dx: float,
                   idx_matrix: np.ndarray, cfg: BootstrapConfig = BootstrapConfig(),
                   disp_cfg: DispersionConfig = DispersionConfig(),
                   ref_vel: Optional[Sequence] = None, disp_start_x: float = -150.0,
                   disp_end_x: float = 0.0, counts: Optional[np.ndarray] = None,
                   device=None):
    """Per-mode bootstrap ridge curves.

    ``gathers``: (n_windows, nch_out, wlen) per-window virtual shot gathers
    (a tensor stays on its device; numpy goes to ``device``, ``None`` = the
    card).  ``idx_matrix``: (bt_times, bt_size) window indices per
    repetition.  ``counts``: optional (bt_times,); row r then uses only its
    first ``counts[r]`` indices.  Returns ``(ridges, freqs)``:
    ``ridges[mode]`` a host (bt_times, n_freqs_in_band) float64 array,
    ``freqs`` the full scan axis."""
    gathers = on_device(gathers, device)
    dev = gathers.device
    freqs = np.arange(disp_cfg.freq_min, disp_cfg.freq_max, disp_cfg.freq_step)
    vels = np.arange(disp_cfg.vel_min, disp_cfg.vel_max, disp_cfg.vel_step)
    idx = torch.as_tensor(np.array(idx_matrix), device=dev, dtype=torch.int64)
    n_modes = len(cfg.freq_lb)
    if ref_vel is None:
        ref_vel = [None] * n_modes
    if counts is None:
        stacks = _resample_stacks(gathers, idx)
    else:
        stacks = _resample_stacks_counts(
            gathers, idx, torch.as_tensor(np.array(counts), device=dev))
    images = gather_disp_image(stacks, np.asarray(offsets), float(dt), float(dx), disp_cfg,
                               float(disp_start_x), float(disp_end_x))
    ridges: List[np.ndarray] = []
    for m in range(n_modes):
        band = (freqs >= cfg.freq_lb[m]) & (freqs < cfg.freq_ub[m])
        # the reference index shifted into the band (apis/imaging_classes.py:45)
        ref_idx = int(cfg.ref_freq_idx[m] - np.sum(freqs < cfg.freq_lb[m]))
        rv = ref_vel[m]
        cols = torch.as_tensor(np.nonzero(band)[0], device=dev)
        ridges.append(extract_ridge_batch(
            freqs[band], vels, images[:, :, cols],
            ref_freq_idx=None if rv is not None else ref_idx,
            sigma=float(cfg.sigma[m]), vel_max=cfg.vel_max, ref_vel=rv).cpu().numpy())
    return ridges, freqs


def convergence_test(gathers, offsets: np.ndarray, dt: float, dx: float,
                     max_sample_num: int, bt_times: int, rng: np.random.Generator,
                     cfg: BootstrapConfig = BootstrapConfig(),
                     disp_cfg: DispersionConfig = DispersionConfig(),
                     ref_vel: Optional[Sequence] = None, device=None) -> np.ndarray:
    """Bootstrap spread against sample count (imaging_diff_speed.ipynb cell
    30): for bt_size = 1..max, the bootstrap's summed per-mode ridge standard
    deviation.  Returns (n_modes, max_sample_num).  Every index matrix is
    padded to ``max_sample_num`` columns with a count mask, as in the JAX
    package."""
    gathers = on_device(gathers, device)
    n_modes = len(cfg.freq_lb)
    out = np.empty((n_modes, max_sample_num))
    for bt_size in range(1, max_sample_num + 1):
        idx = sample_indices(gathers.shape[0], bt_size, bt_times, rng)
        pad = np.broadcast_to(idx[:, :1], (bt_times, max_sample_num - bt_size))
        idx = np.concatenate([idx, pad], axis=1)
        ridges, _ = bootstrap_disp(gathers, offsets, dt, dx, idx, cfg, disp_cfg, ref_vel,
                                   counts=np.full(bt_times, bt_size))
        for m in range(n_modes):
            out[m, bt_size - 1] = float(np.sum(np.std(ridges[m], axis=0)))
    return out
