"""Ambient-noise pre-processing of Bensen et al. (2007, GJI 169:1239-1260,
"Processing seismic ambient noise data to obtain reliable broad-band surface
wave dispersion measurements"): one-bit temporal normalisation of a record
and spectral whitening of its window spectra over a band.

Both are elementwise over channels and windows, so a channel's values do not
depend on which other channels share the call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WHITEN_EPS = float(np.finfo(np.float32).tiny)
"""Floor of the amplitude a whitened bin is divided by: a bin of zero
amplitude (a dead channel) stays zero instead of becoming NaN."""


def one_bit(data: torch.Tensor) -> torch.Tensor:
    """Bensen's one-bit normalisation: each sample replaced by its sign
    (+1, -1, and 0 for an exact zero), in the input's dtype."""
    return torch.sign(data)


def band_bins(fs: float, wlen: int, band_hz) -> tuple:
    """``(lo, hi)``: the first and last rfft bin of a ``wlen``-sample window
    at ``fs`` whose frequency lies inside ``band_hz`` = (f_lo, f_hi)."""
    f_lo, f_hi = band_hz
    lo = max(math.ceil(f_lo * wlen / fs), 0)
    hi = min(math.floor(f_hi * wlen / fs), wlen // 2)
    if lo > hi:
        raise ValueError(f"band {band_hz} Hz holds no bin of a {wlen}-sample window "
                         f"at {fs} Hz")
    return lo, hi


def whiten_band(spectra: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Spectral whitening: ``S / max(|S|, WHITEN_EPS)`` in bins ``lo..hi``
    (unit amplitude, the phase kept), 0 in every other bin.  Works in place
    on ``spectra`` (complex, frequency last) and returns it."""
    band = spectra[..., lo:hi + 1]
    band.div_(band.abs().clamp_min_(WHITEN_EPS))
    spectra[..., :lo] = 0
    spectra[..., hi + 1:] = 0
    return spectra
