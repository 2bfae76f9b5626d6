"""Zero-phase filtering and tapering on tensors.

Mirrors ``das_diff_veh_tpu/ops/filters.py``: the order-10 Butterworth
band-pass is applied as the squared magnitude response |H(f)|^2 of the same
SOS cascade in the frequency domain (rfft * gain * irfft), with odd-extension
padding against the wrap-around transient.  The filter is designed once on
the host with scipy and cast to the data's dtype and device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .constants import device_constant


@functools.lru_cache(maxsize=64)
def _butter_sos(order: int, wlo: float, whi: float) -> np.ndarray:
    """Host-side Butterworth band-pass design (normalized freqs in (0, 1))."""
    from scipy import signal
    return signal.butter(order, [wlo, whi], btype="band", output="sos")


def _sos_gain(sos: np.ndarray, freqs: np.ndarray, fs: float) -> np.ndarray:
    """|H(f)|^2 of an SOS cascade evaluated at ``freqs`` [Hz] (host numpy)."""
    z = np.exp(-2j * np.pi * np.asarray(freqs) / fs)
    h = np.ones_like(z)
    for b0, b1, b2, a0, a1, a2 in sos:
        h = h * (b0 + b1 * z + b2 * z * z) / (a0 + a1 * z + a2 * z * z)
    return np.abs(h) ** 2


def _fft_zero_phase(data: torch.Tensor, fs: float, flo: float, fhi: float,
                    order: int, axis: int) -> torch.Tensor:
    data = torch.movedim(data, axis, -1)
    n = data.shape[-1]
    pad = min(n - 1, max(int(3.0 * fs / max(flo, 1e-6)), 64))
    head = 2.0 * data[..., :1] - data[..., 1:pad + 1].flip(-1)
    tail = 2.0 * data[..., -1:] - data[..., -pad - 1:-1].flip(-1)
    ext = torch.cat([head, data, tail], dim=-1)
    nfft = ext.shape[-1]
    sos = _butter_sos(order, 2.0 * flo / fs, 2.0 * fhi / fs)
    gain = device_constant(
        ("butter_gain", order, flo, fhi, fs, nfft),
        lambda: _sos_gain(sos, np.fft.rfftfreq(nfft, d=1.0 / fs), fs),
        data.dtype, data.device)
    spec = torch.fft.rfft(ext, dim=-1) * gain
    out = torch.fft.irfft(spec, n=nfft, dim=-1)[..., pad:pad + n]
    return torch.movedim(out, -1, axis)


def bandpass_time(data: torch.Tensor, dt: float, flo: float, fhi: float,
                  order: int = 10) -> torch.Tensor:
    """Zero-phase temporal band-pass."""
    return _fft_zero_phase(data, 1.0 / dt, flo, fhi, order, axis=-1)


def bandpass_space(data: torch.Tensor, dx: float, flo: float, fhi: float,
                   order: int = 10) -> torch.Tensor:
    """Zero-phase spatial (wavenumber) band-pass along the channel axis.
    ``flo == fhi == -1`` is a no-op."""
    if flo == -1 and fhi == -1:
        return data
    return _fft_zero_phase(data, 1.0 / dx, flo, fhi, order, axis=0)


def tukey_window(n: int, alpha: float, dtype: torch.dtype = torch.float64,
                 device=None) -> torch.Tensor:
    """Tukey (tapered-cosine) window, closed form; matches
    ``scipy.signal.windows.tukey(n, alpha)``.  Callers pass the data's dtype."""
    if n == 1 or alpha <= 0:
        return torch.ones((n,), dtype=dtype, device=device)
    k = torch.arange(n, dtype=dtype, device=device) / (n - 1)
    edge = alpha / 2.0
    left = 0.5 * (1 + torch.cos(math.pi * (2.0 * k / alpha - 1.0)))
    right = 0.5 * (1 + torch.cos(math.pi * (2.0 * (1.0 - k) / alpha - 1.0)))
    return torch.where(k < edge, left, torch.where(k > 1.0 - edge, right, 1.0))


def taper_time(data: torch.Tensor, alpha: float = 0.05) -> torch.Tensor:
    """Tukey taper along time."""
    return data * tukey_window(data.shape[-1], alpha, data.dtype, data.device)


def detrend_linear(data: torch.Tensor) -> torch.Tensor:
    """Per-trace linear detrend by closed-form least squares
    (``scipy.signal.detrend(type='linear')``)."""
    n = data.shape[-1]
    tc = torch.arange(n, dtype=data.dtype, device=data.device) - (n - 1) / 2.0
    slope = (data @ tc) / torch.sum(tc * tc)
    mean = torch.mean(data, dim=-1)
    return data - mean[..., None] - slope[..., None] * tc


def median(data: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values for an even count
    (``torch.median`` returns the lower one)."""
    s = torch.sort(data, dim=dim).values
    n = s.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    out = (lo + hi) * 0.5
    return out if keepdim else out.squeeze(dim)


def remove_common_mode(data: torch.Tensor) -> torch.Tensor:
    """Subtract the per-time-sample median across channels."""
    return data - median(data, dim=0, keepdim=True)


def das_preprocess(data: torch.Tensor) -> torch.Tensor:
    """Linear detrend, then common-mode removal (reference:
    modules/utils.py:121-124)."""
    return remove_common_mode(detrend_linear(data))


def l2_normalize_traces(data: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Per-trace L2 normalization."""
    return data / (torch.linalg.vector_norm(data, dim=-1, keepdim=True) + eps)
