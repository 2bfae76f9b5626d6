"""Synthetic vehicle-DAS scene generator (numpy; a copy of
``das_diff_veh_tpu/io/synthetic.py``, with the section returned as CPU
tensors).

The reference's analysis inputs (``data/sw_data/700.pkl`` etc., loaded at
imaging_diff_speed.ipynb cell 2) are not shipped with the repo, so this module
generates physically-plausible scenes end-to-end testable against known truth:

- **quasi-static deformation**: a slow negative deflection pulse as each
  vehicle passes each channel (the 0.08-1 Hz band the tracker uses,
  reference apis/timeLapseImaging.py:83-85), amplitude ∝ vehicle weight;
- **dispersive surface waves**: each vehicle radiates a band-limited wavelet
  from every channel crossing, propagated with a prescribed phase-velocity
  curve c(f) — the ground truth the dispersion transform must recover.

The surface-wave synthesis is a per-frequency convolution along the channel
axis (sources live on the same uniform grid as receivers), so the whole scene
is O(nf · nx log nx) instead of O(nf · nx²).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from das_diff_veh_tpu_torch.core.section import DasSection


def default_phase_velocity(freqs: np.ndarray) -> np.ndarray:
    """Smooth fundamental-mode-like Rayleigh curve: fast at low f, slow at high f.

    Shaped to sit inside the reference scan grid (200-1200 m/s, 0.8-25 Hz;
    apis/dispersion_classes.py:11).
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    return 300.0 + 600.0 * np.exp(-np.maximum(freqs, 0.0) / 6.0)


@dataclass
class SceneConfig:
    nch: int = 140
    dx: float = 8.16
    fs: float = 250.0
    duration: float = 120.0
    start_ch: int = 400                 # interrogator channel offset (x = (ch-400)*dx)
    # vehicles
    n_vehicles: int = 6
    speed_range: tuple = (8.0, 22.0)    # m/s
    weight_range: tuple = (0.8, 2.5)    # arbitrary load units
    # quasi-static pulse
    qs_tau: float = 0.9                 # pulse width [s]
    qs_amp: float = 2.0
    # surface waves
    sw_amp: float = 0.35
    sw_fmin: float = 1.0
    sw_fmax: float = 24.0
    attenuation_length: float = 400.0   # exponential decay [m]
    phase_velocity: Callable[[np.ndarray], np.ndarray] = field(default=default_phase_velocity)
    noise_std: float = 0.01
    seed: int = 0


@dataclass
class SceneTruth:
    t_enter: np.ndarray        # (nveh,) entry time at x=0 of the section [s]
    speed: np.ndarray          # (nveh,) m/s
    weight: np.ndarray         # (nveh,)
    phase_velocity: Callable[[np.ndarray], np.ndarray]

    def arrival_times(self, x: np.ndarray) -> np.ndarray:
        """(nveh, nx) arrival time of each vehicle at each position."""
        return self.t_enter[:, None] + np.asarray(x)[None, :] / self.speed[:, None]


def _band_wavelet_spectrum(freqs: np.ndarray, fmin: float, fmax: float) -> np.ndarray:
    """Smooth band-limited amplitude spectrum (cosine-tapered band edges)."""
    f = np.asarray(freqs)
    bw = fmax - fmin
    lo_edge = 0.25 * bw
    amp = np.zeros_like(f)
    inside = (f >= fmin) & (f <= fmax)
    u = np.clip((f - fmin) / lo_edge, 0.0, 1.0) * np.clip((fmax - f) / lo_edge, 0.0, 1.0)
    amp[inside] = np.sin(0.5 * np.pi * np.clip(u[inside], 0, 1)) ** 2
    return amp


def surface_wave_field(nch: int, nt: int, dx: float, dt: float,
                       crossing_times: np.ndarray, amps: np.ndarray,
                       phase_velocity: Callable[[np.ndarray], np.ndarray],
                       fmin: float = 1.0, fmax: float = 24.0,
                       attenuation_length: float = 400.0) -> np.ndarray:
    """(nch, nt) dispersive wavefield radiated by moving sources.

    Source ``v`` fires a band-limited wavelet from every channel it crosses,
    at ``crossing_times[v, ch]`` with amplitude ``amps[v]``; propagation
    along the channel axis uses the prescribed c(f) (per-frequency channel
    convolution, O(nf · nx log nx)).  Shared by the scene synthesizer and
    the benchmark workload builder (each benchmark window radiates from its
    own trajectory instead of re-using one cached shot)."""
    crossing_times = np.atleast_2d(np.asarray(crossing_times, np.float64))
    amps = np.atleast_1d(np.asarray(amps, np.float64))
    nf = 2 * nt                                           # zero-pad to avoid wrap
    freqs = np.fft.rfftfreq(nf, d=dt)                     # (nfr,)
    amp = _band_wavelet_spectrum(freqs, fmin, fmax)
    c = np.maximum(phase_velocity(freqs), 1e-3)           # (nfr,)

    # propagation kernel over channel-offset d >= 0: exp(-i 2π f d / c(f)) decay
    nxp = 2 * nch                                         # zero-pad channel conv
    offs = np.arange(nch) * dx                            # one-sided offsets
    geo = np.exp(-offs / attenuation_length) / np.sqrt(offs + 2.0 * dx)
    kern = geo[None, :] * np.exp(-2j * np.pi * freqs[:, None] * offs[None, :] / c[:, None])
    kern_pos = np.zeros((freqs.size, nxp), dtype=np.complex128)
    kern_pos[:, :nch] = kern                              # causal (rightward) part
    kern_neg = np.zeros_like(kern_pos)
    kern_neg[:, 0] = kern[:, 0]
    kern_neg[:, nxp - nch + 1:] = kern[:, 1:][:, ::-1]    # leftward part
    # two-sided kernel; avoid double-count at zero offset
    kern2 = kern_pos + kern_neg
    kern2[:, 0] = kern[:, 0]
    K = np.fft.fft(kern2, axis=-1)                        # (nfr, nxp)

    sw = np.zeros((nch, nt), dtype=np.float64)
    for v in range(crossing_times.shape[0]):
        # source spectrum per channel crossing: delta at crossing_times[v]
        src = np.zeros((freqs.size, nxp), dtype=np.complex128)
        src[:, :nch] = np.exp(-2j * np.pi * freqs[:, None]
                              * crossing_times[v][None, :])
        U = np.fft.ifft(np.fft.fft(src, axis=-1) * K, axis=-1)[:, :nch]
        U *= (amps[v] * amp)[:, None]
        sw += np.fft.irfft(U.T, n=nf, axis=-1)[:, :nt]
    return sw


def synthesize_section(cfg: SceneConfig):
    """Build one DAS section with cfg.n_vehicles vehicles.

    Returns ``(DasSection, SceneTruth)``.  Data layout matches the reference
    waterfalls: shape (nch, nt), x in meters along fiber, t in seconds.
    """
    rng = np.random.default_rng(cfg.seed)
    nt = int(round(cfg.duration * cfg.fs))
    dt = 1.0 / cfg.fs
    x = np.arange(cfg.nch) * cfg.dx
    t = np.arange(nt) * dt

    span = x[-1] - x[0]
    speed = rng.uniform(*cfg.speed_range, size=cfg.n_vehicles)
    weight = rng.uniform(*cfg.weight_range, size=cfg.n_vehicles)
    # spread entries so each vehicle's full transit fits in the record
    max_transit = span / speed.min()
    t_enter = np.sort(rng.uniform(2.0, max(cfg.duration - max_transit - 2.0, 3.0),
                                  size=cfg.n_vehicles))
    truth = SceneTruth(t_enter=t_enter, speed=speed, weight=weight,
                       phase_velocity=cfg.phase_velocity)

    t_arr = truth.arrival_times(x)                       # (nveh, nx)

    # --- quasi-static deflection: -w * gaussian(t - t_arr(x)) ------------------
    # (nveh, nx, nt) would be large; accumulate per vehicle
    data = np.zeros((cfg.nch, nt), dtype=np.float64)
    for v in range(cfg.n_vehicles):
        pulse = np.exp(-0.5 * ((t[None, :] - t_arr[v][:, None]) / cfg.qs_tau) ** 2)
        data -= cfg.qs_amp * weight[v] * pulse

    # --- dispersive surface waves ---------------------------------------------
    data += surface_wave_field(cfg.nch, nt, cfg.dx, dt, t_arr,
                               cfg.sw_amp * weight, cfg.phase_velocity,
                               cfg.sw_fmin, cfg.sw_fmax,
                               cfg.attenuation_length)
    if cfg.noise_std > 0:
        data += cfg.noise_std * rng.standard_normal(data.shape)

    return (DasSection(torch.from_numpy(data), torch.from_numpy(x),
                       torch.from_numpy(t)), truth)

