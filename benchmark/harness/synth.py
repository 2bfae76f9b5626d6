"""Seeded inputs, made on the card.

:func:`vehicle_chunk` is a 2-minute DAS chunk of vehicles passing a fiber
segment: a copy of the port's scene generator (``io/synthetic.py``:
``synthesize_section`` and ``surface_wave_field``, itself the JAX package's),
rewritten in PyTorch so that it runs on the card in float64 in a few large
calls, and with every vehicle's surface-wave field summed in the frequency
domain before one inverse transform.  The scene's physics and its random
draws are the same: a quasi-static deflection pulse a vehicle and channel,
and a band-limited dispersive surface wave radiated from every channel
crossing, plus white noise (drawn on the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness.traffic import rng


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, 100 + stream).integers(0, 2**63 - 1)))
    return g


def phase_velocity(freqs: torch.Tensor) -> torch.Tensor:
    """The scene's Rayleigh-like dispersion curve (``default_phase_velocity``)."""
    return 300.0 + 600.0 * torch.exp(-torch.clamp(freqs, min=0.0) / 6.0)


def _band_spectrum(f: torch.Tensor, fmin: float, fmax: float) -> torch.Tensor:
    lo_edge = 0.25 * (fmax - fmin)
    u = (torch.clamp((f - fmin) / lo_edge, 0.0, 1.0)
         * torch.clamp((fmax - f) / lo_edge, 0.0, 1.0))
    amp = torch.sin(0.5 * math.pi * u) ** 2
    return torch.where((f >= fmin) & (f <= fmax), amp, torch.zeros_like(amp))


def surface_wave_field(nch: int, nt: int, dx: float, dt: float, crossing: torch.Tensor,
                       amps: torch.Tensor, fmin: float, fmax: float,
                       attenuation_length: float) -> torch.Tensor:
    """(nch, nt) float64 wavefield radiated by ``crossing.shape[0]`` moving
    sources; ``crossing`` (nveh, nch) holds each source's channel-crossing
    times, ``amps`` (nveh,) its amplitude."""
    dev = crossing.device
    nf = 2 * nt
    freqs = torch.fft.rfftfreq(nf, d=dt, dtype=torch.float64, device=dev)
    amp = _band_spectrum(freqs, fmin, fmax)
    c = torch.clamp(phase_velocity(freqs), min=1e-3)
    nxp = 2 * nch
    offs = torch.arange(nch, dtype=torch.float64, device=dev) * dx
    geo = torch.exp(-offs / attenuation_length) / torch.sqrt(offs + 2.0 * dx)
    kern = geo[None, :] * torch.exp(-2j * math.pi * freqs[:, None] * offs[None, :] / c[:, None])
    kern2 = torch.zeros((freqs.numel(), nxp), dtype=torch.complex128, device=dev)
    kern2[:, :nch] = kern
    kern2[:, nxp - nch + 1:] = torch.flip(kern[:, 1:], dims=(1,))
    K = torch.fft.fft(kern2, dim=-1)
    total = torch.zeros((freqs.numel(), nch), dtype=torch.complex128, device=dev)
    for v in range(crossing.shape[0]):
        src = torch.zeros((freqs.numel(), nxp), dtype=torch.complex128, device=dev)
        src[:, :nch] = torch.exp(-2j * math.pi * freqs[:, None] * crossing[v][None, :])
        U = torch.fft.ifft(torch.fft.fft(src, dim=-1) * K, dim=-1)[:, :nch]
        total += U * (amps[v] * amp)[:, None]
    return torch.fft.irfft(total.T, n=nf, dim=-1)[:, :nt]


def vehicle_chunk(scene: dict, seed: int, index: int, device) -> np.ndarray:
    """Chunk ``index`` of ``seed``: (nch, nt) host float64 numpy.

    ``scene`` holds the configuration's scene keys (channels, dx, fs,
    duration, vehicles, speeds, weights, pulse, surface wave, noise)."""
    nch, dx, fs = int(scene["channels"]), float(scene["dx_m"]), float(scene["fs_hz"])
    nt = int(round(float(scene["chunk_s"]) * fs))
    dt = 1.0 / fs
    nveh = int(scene["n_vehicles"])
    r = rng(seed, 10, index)
    speed = r.uniform(*scene["speed_range_m_s"], size=nveh)
    weight = r.uniform(*scene["weight_range"], size=nveh)
    span = (nch - 1) * dx
    max_transit = span / speed.min()
    t_enter = np.sort(r.uniform(2.0, max(nt * dt - max_transit - 2.0, 3.0), size=nveh))
    x = torch.arange(nch, dtype=torch.float64, device=device) * dx
    t = torch.arange(nt, dtype=torch.float64, device=device) * dt
    t_arr = (torch.as_tensor(t_enter, device=device)[:, None]
             + x[None, :] / torch.as_tensor(speed, device=device)[:, None])   # (nveh, nch)
    data = torch.zeros((nch, nt), dtype=torch.float64, device=device)
    for v in range(nveh):
        pulse = torch.exp(-0.5 * ((t[None, :] - t_arr[v][:, None]) / scene["qs_tau_s"]) ** 2)
        data -= scene["qs_amp"] * float(weight[v]) * pulse
    data += surface_wave_field(nch, nt, dx, dt, t_arr,
                               scene["sw_amp"] * torch.as_tensor(weight, device=device),
                               scene["sw_fmin_hz"], scene["sw_fmax_hz"],
                               scene["attenuation_length_m"])
    if scene["noise_std"] > 0:
        g = torch_generator(seed, 1000 + index, device)
        data += scene["noise_std"] * torch.randn((nch, nt), generator=g, dtype=torch.float64,
                                                 device=device)
    return data.cpu().numpy()

