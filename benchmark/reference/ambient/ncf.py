"""Noise-correlation gathers of a record, the plain way (Bensen et al. 2007,
GJI 169:1239-1260, "Processing seismic ambient noise data to obtain reliable
broad-band surface wave dispersion measurements"), in float32 with TF32 off.

For each source channel ``s`` of an (nch, nt) record:

1. one-bit temporal normalisation: every sample replaced by its sign;
2. windows of ``wlen`` samples, one every ``wlen * (1 - overlap_ratio)``;
3. the rfft of each window;
4. spectral whitening: ``S / max(|S|, eps)`` in the bins from
   ``ceil(f_lo * wlen / fs)`` to ``floor(f_hi * wlen / fs)``, 0 in every
   other bin;
5. the window mean of ``S_s * conj(S_r)`` for the ``2 * max_offset + 1``
   receivers ``r = s - max_offset .. s + max_offset`` around the source,
   as one einsum ``"swf,rwf->srf"`` over the source's own band; receivers
   past either end of the array are left at 0;
6. the irfft over ``wlen``, zero lag rolled to the middle, the lags within
   ``max_lag`` samples of zero kept.

The mean over records, step 7, is the caller's: :func:`stacked_gathers`
weights each record by how often it was stacked (stacking is linear).

Departures from Bensen 2007, each as the deployment runs it:

- Whitening divides each bin by its own amplitude inside a hard band;
  Bensen divides by a running mean of the amplitude spectrum and tapers the
  band's edges.
- The correlation is circular within each window (no zero padding) and
  averaged over the windows of a record (a linear stack of windows), then
  over the records of the day; Bensen correlates day-long traces once.  The
  kept lags (``max_lag``) are well inside half a window.
- No instrument response, mean, trend or band-pass is removed before the
  one-bit step: a DAS strain-rate record has no instrument response, and
  the whitening band sets the band.
- ``bf16=True`` rounds the real and imaginary parts of both spectra through
  bfloat16 before step 5: the benchmark's control, not part of the method.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def band_bins(fs: float, wlen: int, band_hz) -> tuple:
    """First and last rfft bin of a ``wlen``-sample window at ``fs`` inside
    ``band_hz``."""
    return math.ceil(band_hz[0] * wlen / fs), min(math.floor(band_hz[1] * wlen / fs),
                                                  wlen // 2)


def window_spectra(record, *, fs: float, wlen: int, overlap_ratio: float, band_hz,
                   one_bit: bool = True, whiten: bool = True,
                   eps: float = float(np.finfo(np.float32).tiny),
                   device="cpu") -> torch.Tensor:
    """Steps 1-4: (nch, nwin, wlen//2+1) complex64."""
    x = torch.as_tensor(record, device=device).to(torch.float32)
    if one_bit:
        x = torch.sign(x)
    step = int(wlen * (1.0 - overlap_ratio))
    nwin = (x.shape[1] - wlen) // step + 1
    wins = torch.stack([x[:, k * step:k * step + wlen] for k in range(nwin)], dim=1)
    spec = torch.fft.rfft(wins, dim=-1)
    if whiten:
        lo, hi = band_bins(fs, wlen, band_hz)
        keep = torch.zeros(spec.shape[-1], dtype=torch.bool, device=spec.device)
        keep[lo:hi + 1] = True
        spec = torch.where(keep, spec / spec.abs().clamp_min(eps), 0)
    return spec


def gathers(record, sources, *, fs: float, wlen: int, overlap_ratio: float, band_hz,
            max_offset: int, max_lag: int, one_bit: bool = True, whiten: bool = True,
            eps: float = float(np.finfo(np.float32).tiny), bf16: bool = False,
            device="cpu") -> torch.Tensor:
    """(len(sources), 2*max_offset+1, 2*max_lag+1) float32 gathers of one
    record: ``out[i, j, max_lag + k]`` is source ``sources[i]`` against
    receiver ``sources[i] + j - max_offset`` at lag ``k``."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        spec = window_spectra(record, fs=fs, wlen=wlen, overlap_ratio=overlap_ratio,
                              band_hz=band_hz, one_bit=one_bit, whiten=whiten, eps=eps,
                              device=device)
        if bf16:
            spec = torch.complex(spec.real.to(torch.bfloat16).to(torch.float32),
                                 spec.imag.to(torch.bfloat16).to(torch.float32))
        nch, nwin, _ = spec.shape
        mid = wlen // 2
        out = torch.zeros((len(sources), 2 * max_offset + 1, 2 * max_lag + 1),
                          dtype=torch.float32, device=spec.device)
        for i, s in enumerate(int(s) for s in sources):
            r0, r1 = max(s - max_offset, 0), min(s + max_offset + 1, nch)
            cross = torch.einsum("swf,rwf->srf", spec[s:s + 1], spec[r0:r1].conj()) / nwin
            lag = torch.fft.irfft(cross[0], n=wlen, dim=-1)
            lag = torch.roll(lag, mid, dims=-1)[:, mid - max_lag:mid + max_lag + 1]
            out[i, r0 - (s - max_offset):r1 - (s - max_offset)] = lag
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def stacked_gathers(records, weights, sources, **kwargs) -> np.ndarray:
    """Step 7: the mean of :func:`gathers` over ``records``, record ``k``
    counted ``weights[k]`` times, on the host in float64."""
    total = None
    for rec, w in zip(records, weights):
        if w:
            g = gathers(rec, sources, **kwargs).cpu().numpy().astype(np.float64) * float(w)
            total = g if total is None else total + g
    return total / float(sum(weights))
