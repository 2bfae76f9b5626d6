"""Savitzky-Golay smoothing as one correlation plus two edge-projection
matmuls, matching ``scipy.signal.savgol_filter(mode='interp')`` (mirrors
``das_diff_veh_tpu/ops/savgol.py``; the coefficients are built on the host)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


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
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=flat.dtype,
                                     device=flat.device)
    # conv1d is a correlation, like lax.conv_general_dilated: reversed taps
    out = F.conv1d(flat[:, None, :], as_t(coeffs[::-1])[None, None, :],
                   padding=half)[:, 0, :]
    head = flat[:, :window] @ as_t(left).T
    tail = flat[:, n - window:] @ as_t(right).T
    out = torch.cat([head, out[:, half:n - half], tail], dim=-1)
    return torch.movedim(out.reshape(shape), -1, axis)
