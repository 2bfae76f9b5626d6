"""Savitzky-Golay smoothing as one correlation plus two edge-projection
matmuls, matching ``scipy.signal.savgol_filter(mode='interp')`` (mirrors
``das_diff_veh_tpu/ops/savgol.py``; the coefficients are built on the host,
and copied to the data's device once, ``core.constants``)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from das_diff_veh_tpu_torch.core.constants import device_constant


@functools.lru_cache(maxsize=32)
def _savgol_matrices(window: int, order: int):
    """(conv_coeffs (window,), left_edge (half, window), right_edge (half, window))."""
    from scipy.signal import savgol_coeffs
    coeffs = savgol_coeffs(window, order)
    half = window // 2
    # centered positions: the same LS projection as scipy's polyfit of the
    # first/last window, better conditioned at high order
    pos = np.arange(window, dtype=np.float64) - half
    V = np.vander(pos, order + 1, increasing=True)
    proj = V @ np.linalg.pinv(V)
    return (np.asarray(coeffs, dtype=np.float64), proj[:half], proj[window - half:])


def savgol_filter(data: torch.Tensor, window: int, order: int, axis: int = -1) -> torch.Tensor:
    """Savitzky-Golay filter matching ``scipy.signal.savgol_filter(mode='interp')``."""
    coeffs, left, right = _savgol_matrices(window, order)
    half = window // 2
    moved = torch.movedim(data, axis, -1)
    shape = moved.shape
    flat = moved.reshape(-1, shape[-1])
    n = flat.shape[-1]
    if window % 2 == 0:
        raise ValueError(f"savgol window must be odd, got {window}")
    if n < window:
        raise ValueError(f"savgol window {window} longer than axis length {n}")
    # conv1d is a correlation, like lax.conv_general_dilated: reversed taps
    taps, left, right = (
        device_constant(("savgol", window, order, i), lambda a=a: a, flat.dtype, flat.device)
        for i, a in enumerate((coeffs[::-1], left, right)))
    out = F.conv1d(flat[:, None, :], taps[None, None, :], padding=half)[:, 0, :]
    head = flat[:, :window] @ left.T
    tail = flat[:, n - window:] @ right.T
    out = torch.cat([head, out[:, half:n - half], tail], dim=-1)
    return torch.movedim(out.reshape(shape), -1, axis)
