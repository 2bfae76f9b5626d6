"""Continuous wavelet transform (Morlet) and the CWT travel-time picker
(mirrors ``das_diff_veh_tpu/ops/cwt.py``; the reference's
``pick_travel_time``, modules/utils.py:19-32).

The transform is one batched frequency-domain product: the rfft of every
trace once, times the analytic Morlet response of every scale at once, then
one inverse FFT of the full spectrum (negative frequencies zero).  The
response is built on the host in float64 and cast to the data's complex
dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from das_diff_veh_tpu_torch.device import on_device

OMEGA0 = 6.0   # standard Morlet centre frequency


def log_freqs(freq_min: float, freq_max: float, n: int = 200) -> np.ndarray:
    """Log-spaced analysis frequencies [Hz], low to high."""
    return np.logspace(np.log10(freq_min), np.log10(freq_max), int(n))


def cwt_morlet(data, fs: float, freqs, omega0: float = OMEGA0, device=None) -> torch.Tensor:
    """Morlet CWT along the last axis: (..., nt) real -> complex (..., nfreq,
    nt).  L2-normalised per scale; the signal is zero-padded to the next
    power of two >= 2*nt so the circular product cannot wrap.  A tensor stays
    on its device; numpy goes to ``device`` (``None`` = the card)."""
    data = on_device(data, device)
    nt = data.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(max(2 * nt, 2))))
    freqs = np.asarray(freqs, dtype=np.float64)
    scales = omega0 / (2.0 * np.pi * freqs)
    w = 2.0 * np.pi * np.fft.rfftfreq(nfft, d=1.0 / fs)
    sw = scales[:, None] * w[None, :]
    psi_hat = (np.pi ** -0.25) * np.exp(-0.5 * (sw - omega0) ** 2) * (w[None, :] > 0)
    psi_hat = psi_hat * np.sqrt(2.0 * np.pi * scales[:, None] * fs)
    cdt = torch.complex128 if data.dtype == torch.float64 else torch.complex64
    psi = torch.as_tensor(psi_hat, device=data.device).to(cdt)
    spec = torch.fft.rfft(data, n=nfft, dim=-1)
    prod = spec[..., None, :] * psi
    return torch.fft.ifft(_rfft_to_full(prod, nfft), dim=-1)[..., :nt]


def _rfft_to_full(half: torch.Tensor, nfft: int) -> torch.Tensor:
    """An rfft-layout spectrum in the full fft layout, zeros in the negative
    frequency bins (the wavelet is analytic, not Hermitian)."""
    pad = nfft - half.shape[-1]
    return torch.cat([half, half.new_zeros(half.shape[:-1] + (pad,))], dim=-1)


def pick_travel_times(gather, dt: float, pick_freq: float = 12.0, freq_min: float = 2.0,
                      freq_max: float = 12.0, nfreq: int = 200, omega0: float = OMEGA0,
                      device=None):
    """Group arrival time per gather trace from the CWT scalogram: the row
    nearest ``pick_freq``, argmax over the positive-lag half.  ``gather``:
    (ntr, nt) with zero lag at ``nt//2``.  Returns ``(times_s (ntr,),
    f_used)``."""
    freqs = log_freqs(freq_min, freq_max, nfreq)
    fi = int(np.argmin(np.abs(freqs - pick_freq)))
    gather = on_device(gather, device)
    nt = gather.shape[-1]
    fs = 1.0 / dt
    mag = torch.abs(cwt_morlet(gather, fs, np.array([freqs[fi]]), omega0=omega0))
    idx = torch.argmax(mag[..., 0, nt // 2:], dim=-1)
    dtype = torch.float64 if mag.dtype == torch.float64 else torch.float32
    return idx.to(dtype) / fs, float(freqs[fi])
