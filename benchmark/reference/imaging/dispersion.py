"""f-k and frequency-velocity (dispersion) transforms.

Mirrors ``das_diff_veh_tpu/ops/dispersion.py``:

- ``fv_map_fk``: 2-D FFT magnitude on a next-pow2+1 padded grid, bilinear
  sampling along k = f/v with out-of-domain queries clamped to the boundary
  (FITPACK's degree-1 spline behavior), Savitzky-Golay smoothing over
  frequency.  The bilinear sampling is two hat-weight contractions, one
  ``matmul`` and one ``einsum``; the JAX package leaves the same two
  products to XLA.  The axes are built on the host in float64 and cast to
  the data's dtype, once per geometry on the data's device
  (``core.constants``), as is the phase-shift's bin index and steering
  axes.
- ``fv_map_phase_shift``: the frequency-domain slant stack
  P(v, f) = |sum_x U(x, f) exp(i direction 2 pi f (x - x0) / v)|, one
  complex contraction per chunk of velocities.

Both take a ``precision`` tier: ``"f32"`` keeps full-width contractions
(TF32 off); ``"bf16"`` rounds the contraction operands through bfloat16
first, as the JAX package does, and contracts in float32.  Both take leading
batch dimensions on the data.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import host_constant
from .precision import bf16_round, check_precision
from .savgol import savgol_filter


def _next_pow2_plus(n: int) -> int:
    """Padded FFT size: 2 ** (1 + ceil(log2 n))."""
    return 2 ** (1 + math.ceil(math.log2(n)))


def _fk_axes(nk: int, nf: int, dx: float, dt: float):
    return (np.arange(-nf / 2, nf / 2) / nf / dt,
            np.arange(-nk / 2, nk / 2) / nk / dx)


def fk_transform(data: torch.Tensor, dx: float, dt: float):
    """2-D f-k magnitude spectrum with fftshifted axes.

    Returns (fk_mag (..., nk, nf), f_axis (nf,), k_axis (nk,))."""
    f_axis, k_axis = _fk_axes(_next_pow2_plus(data.shape[-2]),
                              _next_pow2_plus(data.shape[-1]), dx, dt)
    as_t = lambda a: torch.as_tensor(a, dtype=data.dtype, device=data.device)
    return _fk_mag(data), as_t(f_axis), as_t(k_axis)


def _fk_mag(data: torch.Tensor) -> torch.Tensor:
    """|fftshift(fft2)| on the next-pow2+1 padded grid (no host axes)."""
    nk, nf = _next_pow2_plus(data.shape[-2]), _next_pow2_plus(data.shape[-1])
    spec = torch.fft.fftshift(torch.fft.fft2(data, s=(nk, nf)), dim=(-2, -1))
    return torch.abs(spec)


def _hat(centers: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation hat weights max(0, 1 - |center - u|): for a u
    clamped inside the grid, exactly the clamped bilinear weights."""
    return torch.clamp(1.0 - torch.abs(centers - u), min=0.0)


def fv_map_fk(data: torch.Tensor, dx: float, dt: float, freqs, vels,
              norm: bool = False, sg_window: int = 25, sg_order: int = 4,
              precision: str = "f32") -> torch.Tensor:
    """Reference-parity dispersion map of (..., nch, nt) data: returns
    (..., nvel, nfreq).

    ``norm`` applies the per-trace L1 normalization before the transform.
    ``freqs``/``vels`` are host arrays.  ``precision="bf16"`` rounds the f-k
    magnitude (cast to float32 first, whatever the data's dtype) and both
    hat-weight matrices through bfloat16 and contracts in float32."""
    check_precision(precision)
    if norm:
        data = data / torch.linalg.vector_norm(data, ord=1, dim=-1, keepdim=True)
    nk, nf = _next_pow2_plus(data.shape[-2]), _next_pow2_plus(data.shape[-1])
    fk_mag = _fk_mag(data)
    if precision == "bf16":
        fk_mag = bf16_round(fk_mag)
    f_axis, k_axis = _fk_axes(nk, nf, dx, dt)
    # uniform axes -> index arithmetic instead of searchsorted
    f0, df = float(f_axis[0]), float(f_axis[1] - f_axis[0])
    k0, dk = float(k_axis[0]), float(k_axis[1] - k_axis[0])
    kw = dict(dtype=data.dtype, device=data.device)
    fr = host_constant(freqs, **kw)
    vl = host_constant(vels, **kw)
    # f-direction: one clamped position per output column
    uf = torch.clamp((fr - f0) / df, 0.0, nf - 1.0)                 # (nfreq,)
    Wf = _hat(torch.arange(nf, **kw)[:, None], uf[None, :])         # (nf_pad, nfreq)
    if precision == "bf16":
        Wf = bf16_round(Wf)
    colmix = torch.matmul(fk_mag, Wf)                               # (nk, nfreq)
    # k-direction: per-(v, f) clamped position k = f/v
    uk = torch.clamp((fr[None, :] / vl[:, None] - k0) / dk, 0.0, nk - 1.0)
    Wk = _hat(torch.arange(nk, **kw), uk[..., None])                # (nvel, nfreq, nk)
    if precision == "bf16":
        Wk = bf16_round(Wk)
    vals = torch.einsum("vfk,...kf->...vf", Wk, colmix)             # (..., nvel, nfreq)
    return savgol_filter(vals, sg_window, sg_order, axis=-1)        # over frequency


def fv_map_phase_shift(data: torch.Tensor, dx: float, dt: float, freqs, vels,
                       whiten: bool = True, x0: float = 0.0, direction: float = 1.0,
                       vel_chunk: int = 128, precision: str = "f32") -> torch.Tensor:
    """Phase-shift (frequency-domain slant stack) dispersion map of
    (..., nch, nt) data: returns (..., nvel, nfreq).

    P(v, f) = |sum_x U(x, f) exp(i direction 2 pi f (x - x0) / v)|, with
    optional spectral whitening U -> U/|U|.  The spectrum is sampled at the
    nearest FFT bin of each scan frequency (``round`` is half to even, as in
    numpy and JAX).  ``direction=+1`` stacks waves toward increasing x.
    Velocities run in chunks of ``vel_chunk``, the last padded with the last
    velocity and cut back.  The steering phase is built in float64 on the
    data's device.  ``precision="bf16"`` rounds the real and imaginary
    planes of the sampled spectrum and of the steering tensor through
    bfloat16 (complex64 out)."""
    check_precision(precision)

    def _round_c(z):
        if precision != "bf16":
            return z
        z = z.to(torch.complex64)
        return torch.complex(bf16_round(z.real), bf16_round(z.imag))

    nch, nt = data.shape[-2], data.shape[-1]
    dev = data.device
    spec = torch.fft.rfft(data, dim=-1)                             # (..., nch, nfr)
    if whiten:
        spec = spec / (torch.abs(spec) + 1e-20)
    fr = np.asarray(freqs, dtype=np.float64)
    fbin = np.clip(np.round(fr * nt * dt).astype(np.int64), 0, nt // 2)
    u = _round_c(spec[..., host_constant(fbin, torch.int64, dev)])  # (..., nch, nfreq)
    f64 = dict(dtype=torch.float64, device=dev)
    x = torch.arange(nch, **f64) * dx - x0
    frt = host_constant(fr, **f64)
    vl = np.asarray(vels, dtype=np.float64)
    nv = vl.size
    pad = (-nv) % vel_chunk
    vl_pad = host_constant(np.concatenate([vl, np.full(pad, vl[-1])]), **f64)
    out = []
    for vc in vl_pad.reshape(-1, vel_chunk):
        phase = 2.0 * math.pi * frt[None, :, None] * x[None, None, :] / vc[:, None, None]
        steer = _round_c(torch.exp(1j * direction * phase)).to(u.dtype)   # (nvc, nfreq, nch)
        out.append(torch.abs(torch.einsum("...xf,vfx->...vf", u, steer)))
    return torch.cat(out, dim=-2)[..., :nv, :]


def stack_fv_maps(maps: torch.Tensor) -> torch.Tensor:
    """Average a (nwin, nvel, nfreq) batch of maps."""
    return maps.mean(dim=0)
