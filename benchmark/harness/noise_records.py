"""Seeded ambient-noise records of a straight fiber, made on the card.

:func:`ambient_record` is one record of ``channels`` x ``record_s * fs``
samples: unit Gaussian noise plus ``n_waves`` plane waves, each a
band-limited random signal crossing the whole fiber at a constant apparent
speed, in either direction.  Each wave is drawn as a spectrum (the
scene generator's band taper, ``harness.synth._band_spectrum``, over random
complex Gaussian bins), delayed channel by channel in the frequency domain,
and summed before one inverse transform per slab of channels; the delay
wraps round the record, which a stationary noise field does not mind.
The result comes to the host as float32, as a reader hands a record over.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness.synth import _band_spectrum, torch_generator
from harness.traffic import rng

SLAB = 512          # channels a frequency-domain slab


def _wave_spectra(cfg: dict, seed: int, index: int, nt: int, device) -> tuple:
    """(spectra (n_waves, nf) complex128, delays-per-metre (n_waves,),
    far-end flags (n_waves,)) of one record's waves, each scaled to its
    drawn RMS amplitude."""
    n = int(cfg["n_waves"])
    r = rng(seed, 30, index)
    speed = r.uniform(*cfg["wave_speed_range_m_s"], size=n)
    amp = r.uniform(*cfg["wave_rms_range"], size=n)
    from_far_end = r.integers(0, 2, size=n).astype(bool)
    f = torch.fft.rfftfreq(nt, d=1.0 / float(cfg["fs_hz"]), dtype=torch.float64, device=device)
    taper = _band_spectrum(f, *map(float, cfg["wave_band_hz"]))
    g = torch_generator(seed, 3000 + index, device)
    re = torch.randn((n, f.numel()), generator=g, dtype=torch.float64, device=device)
    im = torch.randn((n, f.numel()), generator=g, dtype=torch.float64, device=device)
    spec = torch.complex(re, im) * taper
    # Parseval: the irfft of spec has RMS sqrt(sum |spec|^2 weighted) / nt
    w = torch.full((f.numel(),), 2.0, dtype=torch.float64, device=device)
    w[0] = 1.0
    if nt % 2 == 0:
        w[-1] = 1.0
    rms = torch.sqrt((w * spec.abs() ** 2).sum(dim=1)) / nt
    spec = spec * (torch.as_tensor(amp, device=device) / rms)[:, None]
    return spec, f, 1.0 / speed, from_far_end


def ambient_record(cfg: dict, seed: int, index: int, device) -> np.ndarray:
    """Record ``index`` of ``seed``: (channels, nt) host float32 numpy."""
    nch = int(cfg["channels"])
    fs, dx = float(cfg["fs_hz"]), float(cfg["dx_m"])
    nt = int(round(float(cfg["record_s"]) * fs))
    spec, f, slowness, far = _wave_spectra(cfg, seed, index, nt, device)
    g = torch_generator(seed, 2000 + index, device)
    out = torch.randn((nch, nt), generator=g, dtype=torch.float32, device=device)
    out *= float(cfg["noise_std"])
    span = (nch - 1) * dx
    for c0 in range(0, nch, SLAB):
        x = torch.arange(c0, min(c0 + SLAB, nch), dtype=torch.float64, device=device) * dx
        total = torch.zeros((x.numel(), f.numel()), dtype=torch.complex128, device=device)
        for k in range(spec.shape[0]):
            dist = (span - x) if far[k] else x
            phase = -2.0 * math.pi * f[None, :] * (dist[:, None] * slowness[k])
            total += spec[k][None, :] * torch.polar(torch.ones_like(phase), phase)
        out[c0:c0 + x.numel()] += torch.fft.irfft(total, n=nt, dim=-1).to(torch.float32)
    return out.cpu().numpy()
