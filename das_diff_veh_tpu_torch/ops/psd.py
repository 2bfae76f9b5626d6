"""Welch power spectral density matching ``scipy.signal.welch`` defaults
(mirrors ``das_diff_veh_tpu/ops/psd.py``): periodic hann window, 50 %
overlap, constant detrend, density scaling, one-sided."""

from __future__ import annotations

import math

import numpy as np
import torch

from das_diff_veh_tpu_torch.device import on_device


def _hann_periodic(n: int, dtype, device) -> torch.Tensor:
    """Periodic hann, what ``scipy.signal.get_window('hann')`` returns."""
    k = torch.arange(n, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def welch_psd(data, fs: float, nperseg: int = 2048, noverlap: int | None = None,
              nfft: int | None = None, device=None):
    """Welch PSD along the last axis.  Returns ``(freqs, Pxx)``: ``freqs`` a
    host float64 array, ``Pxx`` on the data's device (a tensor stays where it
    is; numpy goes to ``device``, ``None`` = the card).  ``nperseg`` shrinks
    to the signal length, as in the JAX package."""
    data = on_device(data, device)
    n = data.shape[-1]
    nperseg = min(nperseg, n)
    if noverlap is None:
        noverlap = nperseg // 2
    if nfft is None:
        nfft = nperseg
    if nfft < nperseg:
        raise ValueError(f"nfft ({nfft}) must be >= nperseg ({nperseg})")
    if noverlap >= nperseg:
        raise ValueError(f"noverlap ({noverlap}) must be < nperseg ({nperseg}; "
                         f"note nperseg shrinks to the signal length {n})")
    step = nperseg - noverlap
    nseg = (n - noverlap) // step
    segs = data.unfold(-1, nperseg, step)[..., :nseg, :]     # (..., nseg, nperseg)
    segs = segs - torch.mean(segs, dim=-1, keepdim=True)
    win = _hann_periodic(nperseg, data.dtype, data.device)
    spec = torch.fft.rfft(segs * win, n=nfft, dim=-1)
    scale = 1.0 / (fs * torch.sum(win * win))
    p = (torch.abs(spec) ** 2) * scale
    # one-sided: double everything but DC (and Nyquist when nfft is even)
    mult = torch.full((nfft // 2 + 1,), 2.0, dtype=data.dtype, device=data.device)
    mult[0] = 1.0
    if nfft % 2 == 0:
        mult[-1] = 1.0
    p = p * mult
    return np.fft.rfftfreq(nfft, d=1.0 / fs), torch.mean(p, dim=-2)


def stack_avg_psd(window_data, fs: float, nperseg: int = 2048, device=None):
    """Average PSD over channels then windows (the reference's win_avg_psd).
    ``window_data``: (nwin, nch, nt).  Returns ``(freqs, avg, per_window)``."""
    freqs, p = welch_psd(window_data, fs, nperseg=nperseg, device=device)
    per_window = torch.mean(p, dim=1)
    return freqs, torch.mean(per_window, dim=0), per_window
