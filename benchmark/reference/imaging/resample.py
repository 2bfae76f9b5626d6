"""Polyphase rational resampling (``scipy.signal.resample_poly`` equivalent).

Mirrors ``das_diff_veh_tpu/ops/resample.py``, which zero-stuffs the record
and runs one strided convolution with scipy's default Kaiser anti-alias FIR.
That map is linear in the input, so here it is built once on the host as the
dense ``(n, n_out)`` matrix of the same filter taps and applied with one
matmul: the same products, summed in another order.  A ``conv1d`` over the
zero-stuffed record would unfold every output's 4081 taps on the CPU: a
224 GB im2col buffer for the 6000 rows of a 140-channel chunk
(``tools/port_parity.py`` computes it).  The matrix is copied to the
data's device once per geometry (``core.constants``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .constants import device_constant


@functools.lru_cache(maxsize=16)
def _default_filter(up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly's default anti-alias FIR (kaiser beta=5)."""
    from scipy.signal import firwin
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, f_c, window=("kaiser", 5.0))
    return np.asarray(h, dtype=np.float64) * up


@functools.lru_cache(maxsize=16)
def _resample_matrix(n: int, up: int, down: int) -> np.ndarray:
    """``M[m, j]``: weight of input sample ``m`` in output sample ``j``.

    Output ``j`` of the zero-stuffed convolution (filter reversed, ``half``
    samples of zero padding, stride ``down``) taps the stuffed sample
    ``m*up`` through filter index ``K - 1 - (m*up - j*down + half)``."""
    h = _default_filter(up, down)
    taps = len(h)
    half = (taps - 1) // 2
    n_out = -(-n * up // down)
    tap = (np.arange(n)[:, None] * up - np.arange(n_out)[None, :] * down + half)
    inside = (tap >= 0) & (tap < taps)
    return np.where(inside, h[::-1][np.clip(tap, 0, taps - 1)], 0.0)


def resample_poly(data: torch.Tensor, up: int, down: int, axis: int = 0) -> torch.Tensor:
    """Rational-rate polyphase resample along ``axis``; matches
    ``scipy.signal.resample_poly`` (default window, zero padding)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return data
    moved = torch.movedim(data, axis, -1)
    n = moved.shape[-1]
    m = device_constant(("resample", n, up, down), lambda: _resample_matrix(n, up, down),
                        data.dtype, data.device)
    return torch.movedim(moved @ m, -1, axis)
