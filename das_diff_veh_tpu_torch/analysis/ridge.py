"""Dispersion-curve (ridge) extraction from f-v maps (mirrors
``das_diff_veh_tpu/analysis/ridge.py``; the reference's
``extract_ridge_ref_idx``, modules/utils.py:621-678).

The velocity axis is reversed to descending, then one of three modes:

- no reference index: plain argmax per frequency below ``vel_max``
  (returned unsmoothed, as in the JAX package);
- reference index: the argmax at the reference frequency, then walks
  backward and forward taking the argmax within ±sigma of the previous pick
  (a host loop over the frequency columns, batched over the maps; the pick
  stays on the device);
- reference curve ``ref_vel(freq)``: the masked argmax around the curve at
  every frequency at once.

Masked argmaxes fill with -inf and take the first maximum, as ``jnp.argmax``
does.  The velocity axis and the picks are float64 whatever the maps' dtype,
as in the JAX package (its axes are numpy float64); the picked curve of the
two reference modes is Savitzky-Golay(25,2) smoothed.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from das_diff_veh_tpu_torch.device import on_device
from das_diff_veh_tpu_torch.ops.savgol import savgol_filter


def _masked_argmax_vel(cols: torch.Tensor, vel: torch.Tensor, center: torch.Tensor,
                       sigma: float) -> torch.Tensor:
    """``cols`` (..., nvel), ``center`` (...,): the velocity of the first
    maximum inside (center - sigma, center + sigma)."""
    mask = (vel > center[..., None] - sigma) & (vel < center[..., None] + sigma)
    score = torch.where(mask, cols, torch.full_like(cols, -torch.inf))
    return vel[torch.argmax(score, dim=-1)]


def _core(fv: torch.Tensor, vel_rev: torch.Tensor, centers, max_idx: Optional[int],
          ref_freq_idx: Optional[int], sigma: float, sg_window: int,
          sg_order: int) -> torch.Tensor:
    """Ridges of velocity-reversed maps ``fv`` (n_maps, nvel, nfreq)."""
    if max_idx is not None:
        # the plain argmax is returned unsmoothed, as in the JAX package
        return vel_rev[max_idx:][torch.argmax(fv[:, max_idx:], dim=1)]
    if centers is not None:
        cols = fv.transpose(1, 2)                                  # (n, nfreq, nvel)
        picked = _masked_argmax_vel(cols, vel_rev, centers[None, :].expand(cols.shape[:2]),
                                    sigma)
    else:
        v0 = vel_rev[torch.argmax(fv[:, :, ref_freq_idx], dim=-1)]  # (n,)
        nfreq = fv.shape[-1]
        picks = [None] * nfreq
        picks[ref_freq_idx] = v0
        prev = v0
        for j in range(ref_freq_idx - 1, -1, -1):
            prev = picks[j] = _masked_argmax_vel(fv[:, :, j], vel_rev, prev, sigma)
        prev = v0
        for j in range(ref_freq_idx + 1, nfreq):
            prev = picks[j] = _masked_argmax_vel(fv[:, :, j], vel_rev, prev, sigma)
        picked = torch.stack(picks, dim=-1)
    return savgol_filter(picked, sg_window, sg_order, axis=-1)


def _prep(freq, vel, ref_freq_idx, vel_max: float, ref_vel, device):
    """Host-side geometry of the batched entry, float64."""
    freq = np.asarray(freq)
    vel_rev = torch.as_tensor(np.array(vel, dtype=np.float64)[::-1].copy(), device=device)
    centers = max_idx = None
    if ref_freq_idx is None and ref_vel is None:
        max_idx = int(np.abs(vel_max - np.asarray(vel)[::-1]).argmin())
    elif ref_vel is not None:
        c = ref_vel(freq) if callable(ref_vel) else np.asarray(ref_vel)
        centers = torch.as_tensor(np.array(c, dtype=np.float64), device=device)
        ref_freq_idx = None
    return vel_rev, centers, max_idx, ref_freq_idx


def extract_ridge_batch(freq, vel, fv_maps, ref_freq_idx: Optional[int] = None,
                        sigma: float = 25.0, vel_max: float = 400.0,
                        ref_vel: Optional[Callable] = None, sg_window: int = 25,
                        sg_order: int = 2, device=None) -> torch.Tensor:
    """Ridges (n_maps, len(freq)) of a (n_maps, nvel, nfreq) batch of maps,
    on the maps' device (numpy goes to ``device``, ``None`` = the card)."""
    fv_maps = on_device(fv_maps, device)
    vel_rev, centers, max_idx, ref_freq_idx = _prep(freq, vel, ref_freq_idx, vel_max, ref_vel,
                                                    fv_maps.device)
    return _core(fv_maps.flip(1), vel_rev, centers, max_idx,
                 None if ref_freq_idx is None else int(ref_freq_idx),
                 float(sigma), sg_window, sg_order)


def extract_ridge(freq, vel, fv_map, ref_freq_idx: Optional[int] = None,
                  sigma: float = 25.0, vel_max: float = 400.0,
                  ref_vel: Optional[Callable] = None, sg_window: int = 25,
                  sg_order: int = 2, device=None) -> torch.Tensor:
    """The ridge curve (len(freq),) of one map ``fv_map`` (nvel, nfreq)."""
    fv_map = on_device(fv_map, device)
    return extract_ridge_batch(freq, vel, fv_map[None], ref_freq_idx, sigma, vel_max,
                               ref_vel, sg_window, sg_order)[0]
