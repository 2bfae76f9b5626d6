"""f-k and frequency-velocity (dispersion) transforms.

Mirrors the ``fv_map_fk`` path of ``das_diff_veh_tpu/ops/dispersion.py``:
2-D FFT magnitude on a next-pow2+1 padded grid, bilinear sampling along
k = f/v with out-of-domain queries clamped to the boundary (FITPACK's
degree-1 spline behavior), Savitzky-Golay smoothing over frequency.  The
bilinear sampling is two hat-weight contractions, one ``matmul`` and one
``einsum``; the JAX package leaves the same two products to XLA.  The axes
are built on the host in float64 and cast to the data's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from das_diff_veh_tpu_torch.ops.savgol import savgol_filter


def _next_pow2_plus(n: int) -> int:
    """Padded FFT size: 2 ** (1 + ceil(log2 n))."""
    return 2 ** (1 + math.ceil(math.log2(n)))


def _fk_axes(nk: int, nf: int, dx: float, dt: float):
    return (np.arange(-nf / 2, nf / 2) / nf / dt,
            np.arange(-nk / 2, nk / 2) / nk / dx)


def fk_transform(data: torch.Tensor, dx: float, dt: float):
    """2-D f-k magnitude spectrum with fftshifted axes.

    Returns (fk_mag (..., nk, nf), f_axis (nf,), k_axis (nk,))."""
    nch, nt = data.shape[-2], data.shape[-1]
    nf = _next_pow2_plus(nt)
    nk = _next_pow2_plus(nch)
    spec = torch.fft.fftshift(torch.fft.fft2(data, s=(nk, nf)), dim=(-2, -1))
    f_axis, k_axis = _fk_axes(nk, nf, dx, dt)
    as_t = lambda a: torch.as_tensor(a, dtype=data.dtype, device=data.device)
    return torch.abs(spec), as_t(f_axis), as_t(k_axis)


def _hat(centers: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation hat weights max(0, 1 - |center - u|): for a u
    clamped inside the grid, exactly the clamped bilinear weights."""
    return torch.clamp(1.0 - torch.abs(centers - u), min=0.0)


def fv_map_fk(data: torch.Tensor, dx: float, dt: float, freqs, vels,
              norm: bool = False, sg_window: int = 25, sg_order: int = 4,
              precision: str = "f32") -> torch.Tensor:
    """Reference-parity dispersion map of (nch, nt) data: returns (nvel, nfreq).

    ``norm`` applies the per-trace L1 normalization before the transform.
    ``freqs``/``vels`` are host arrays.  Only the ``"f32"`` precision tier
    (full-width contractions, TF32 off) is ported."""
    if precision != "f32":
        raise NotImplementedError(f"precision={precision!r} is not ported yet; use 'f32'")
    if norm:
        data = data / torch.linalg.vector_norm(data, ord=1, dim=-1, keepdim=True)
    nk, nf = _next_pow2_plus(data.shape[-2]), _next_pow2_plus(data.shape[-1])
    fk_mag, _, _ = fk_transform(data, dx, dt)
    f_axis, k_axis = _fk_axes(nk, nf, dx, dt)
    # uniform axes -> index arithmetic instead of searchsorted
    f0, df = float(f_axis[0]), float(f_axis[1] - f_axis[0])
    k0, dk = float(k_axis[0]), float(k_axis[1] - k_axis[0])
    kw = dict(dtype=data.dtype, device=data.device)
    fr = torch.as_tensor(np.asarray(freqs), **kw)
    vl = torch.as_tensor(np.asarray(vels), **kw)
    # f-direction: one clamped position per output column
    uf = torch.clamp((fr - f0) / df, 0.0, nf - 1.0)                 # (nfreq,)
    Wf = _hat(torch.arange(nf, **kw)[:, None], uf[None, :])         # (nf_pad, nfreq)
    colmix = torch.matmul(fk_mag, Wf)                               # (nk, nfreq)
    # k-direction: per-(v, f) clamped position k = f/v
    uk = torch.clamp((fr[None, :] / vl[:, None] - k0) / dk, 0.0, nk - 1.0)
    Wk = _hat(torch.arange(nk, **kw), uk[..., None])                # (nvel, nfreq, nk)
    vals = torch.einsum("vfk,kf->vf", Wk, colmix)                   # (nvel, nfreq)
    return savgol_filter(vals, sg_window, sg_order, axis=-1)        # over frequency
