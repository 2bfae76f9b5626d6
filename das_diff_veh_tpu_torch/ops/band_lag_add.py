"""The day stack's banded finish over the whitening band alone: each pair's
cross-spectrum through a band-pruned inverse real FFT, cut to the lags
within ``max_lag`` of zero and added into the pair's row of the stack.  It
replaces no TPU kernel (the JAX package has no day stack); it takes the place
of cuFFT's c2r over the whole window, the copy of its input and the strided
band add in ``ops.all_pairs._banded_finish``, wherever the spectra carry a
whitening band.

For a chunk's (m, nb, wlen/2+1) cross-spectra, source ``i`` and band slot
``j`` read receiver row ``i + j - lead``; a row outside ``[0, nb)`` is a
receiver past either end of the array and its stack row is left as it is.
Bins outside ``lo..hi`` are taken as 0, as whitening leaves them, and bins 0
and ``wlen/2`` follow c2r's rule (their imaginary parts dropped).

Every band bin below ``wlen/2`` lies below ``Q``, the smallest power of two
above the last of them (at least 16), so the lags ``n = r + P*m``,
``P = wlen/Q``, are ``P`` twiddled ``Q``-point inverse FFTs, and the real
parts of rows ``r`` and ``r + P/2`` come out of one complex FFT
(``csrc/band_lag_add.cu`` sets out the algebra).  For the PoroTomo DASH day
stack (wlen 4096, bins 9..204) that is 8 complex 256-point FFTs a pair in
place of a 4096-point c2r.  Both versions take their twiddles from one
table made in float64 and rounded once (:func:`twiddle_table`).

:func:`band_lag_add` is the wrapper: for CUDA tensors it launches the
hand-written kernel ``csrc/band_lag_add.cu`` or raises; for CPU tensors it
runs :func:`band_lag_add_plain`, the same decomposition in plain PyTorch
(``torch.fft.ifft`` for the ``Q``-point transforms).  ``launches`` counts
kernel launches and nothing else.  Windows of 64 to 8192 samples, a power
of two, are taken (:func:`takes`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

launches = 0
WLEN_MIN, WLEN_MAX = 64, 8192
Q_MIN = 16
_TABLES: dict = {}


def takes(wlen: int) -> bool:
    """Whether windows of ``wlen`` samples are taken: a power of two from
    ``WLEN_MIN`` to ``WLEN_MAX``."""
    return WLEN_MIN <= wlen <= WLEN_MAX and wlen & (wlen - 1) == 0


@functools.lru_cache(maxsize=None)
def band_plan(wlen: int, lo: int, hi: int) -> tuple:
    """``(Q, P)`` for band bins ``lo..hi`` of a ``wlen``-sample window:
    ``Q`` the smallest power of two above the band's last bin below
    ``wlen//2``, at least ``Q_MIN``; ``P = wlen // Q``."""
    if not takes(wlen):
        raise ValueError(f"band_lag_add takes windows of {WLEN_MIN} to {WLEN_MAX} samples, "
                         f"a power of two, got {wlen}")
    if not 0 <= lo <= hi <= wlen // 2:
        raise ValueError(f"band bins {lo}..{hi} are not within 0..{wlen // 2}")
    top = min(hi, wlen // 2 - 1)
    q = Q_MIN
    while lo <= top and q <= top:
        q *= 2
    return q, wlen // q


def radices(q: int) -> list:
    """The kernel's Stockham radices for a ``q``-point FFT: 2, 4, 8 or 16
    first, then 16s."""
    k = q.bit_length() - 1
    first = 1 << (k % 4) if k % 4 else 16
    return [first] + [16] * ((k - first.bit_length() + 1) // 4)


def twiddle_table(wlen: int, q: int, device=None) -> torch.Tensor:
    """complex64 twiddles for ``(wlen, q)``, each computed in float64 and
    rounded once (w = e^{2 pi i / wlen}): ``w^{k p}`` as ``P`` rows of ``q``
    (k < q), then ``c_p = w^{-q p}`` (p < P), then each radix-16 stage's
    ``w^{r k wlen / (16 ns)}`` as 16 rows of ``ns`` (``ns`` the product of
    the radices before it).  Cached per device."""
    dev = torch.device(device if device is not None else "cpu")
    key = (wlen, q, str(dev))
    if key not in _TABLES:
        p = wlen // q
        idx = [(np.arange(p)[:, None] * np.arange(q)[None, :]).ravel(),
               (-q * np.arange(p)) % wlen]
        ns = radices(q)[0]
        for _ in radices(q)[1:]:
            idx.append((np.arange(16)[:, None] * np.arange(ns)[None, :]).ravel()
                       * (wlen // (16 * ns)))
            ns *= 16
        e = np.concatenate(idx) % wlen
        tab = np.exp(2j * np.pi * e.astype(np.float64) / wlen).astype(np.complex64)
        _TABLES[key] = torch.from_numpy(tab).to(dev)
    return _TABLES[key]


def _check(cross: torch.Tensor, out: torch.Tensor, lo: int, hi: int, wlen: int,
           max_lag: int) -> None:
    if cross.dtype != torch.complex64 or cross.dim() != 3:
        raise ValueError(f"band_lag_add takes (m, nb, nf) complex64 cross-spectra, got "
                         f"{tuple(cross.shape)} {cross.dtype}")
    if out.dtype != torch.float32 or out.dim() != 3:
        raise ValueError(f"band_lag_add adds into an (m, width, 2*max_lag+1) float32 "
                         f"stack, got {tuple(out.shape)} {out.dtype}")
    if out.device != cross.device:
        raise ValueError(f"cross-spectra on {cross.device}, stack on {out.device}")
    if not (cross.is_contiguous() and out.is_contiguous()):
        raise ValueError("band_lag_add needs contiguous cross-spectra and stack rows")
    band_plan(wlen, lo, hi)
    if cross.shape[2] != wlen // 2 + 1:
        raise ValueError(f"cross-spectra of a {wlen}-sample window have {wlen // 2 + 1} "
                         f"bins, got {cross.shape[2]}")
    if out.shape[0] != cross.shape[0] or out.shape[2] != 2 * max_lag + 1 \
            or not 0 <= 2 * max_lag + 1 <= wlen:
        raise ValueError(f"stack rows {tuple(out.shape)} do not fit {cross.shape[0]} "
                         f"sources and max_lag={max_lag} in a {wlen}-sample window")


def in_array(m: int, nb: int, width: int, lead: int) -> torch.Tensor:
    """(m, width) bool: which band slots of a chunk are receivers inside the
    array (receiver row ``i + j - lead`` in ``[0, nb)``)."""
    rows = torch.arange(m)[:, None] + torch.arange(width)[None, :] - lead
    return (rows >= 0) & (rows < nb)


def band_lag_add_plain(cross: torch.Tensor, out: torch.Tensor, lead: int, lo: int,
                       hi: int, wlen: int, max_lag: int) -> None:
    """Add the lags within ``max_lag`` of zero of every in-array pair's
    band-limited inverse real FFT, times ``1/wlen``, into ``out`` (module
    docstring), in plain PyTorch: the kernel's decomposition and twiddles,
    with ``torch.fft.ifft`` for the ``Q``-point transforms."""
    _check(cross, out, lo, hi, wlen, max_lag)
    m, nb, _ = cross.shape
    q, p = band_plan(wlen, lo, hi)
    h = p // 2
    ii, jj = in_array(m, nb, out.shape[1], lead).nonzero(as_tuple=True)
    if ii.numel() == 0:
        return
    dev = cross.device
    ii, jj = ii.to(dev), jj.to(dev)
    spec = cross[ii, ii + jj - lead]                             # (n, nf)
    tab = twiddle_table(wlen, q, dev)
    pre, c = tab[:wlen].view(p, q), tab[wlen:wlen + p]
    top = min(hi, wlen // 2 - 1)
    x = torch.zeros((spec.shape[0], q), dtype=torch.complex64, device=dev)
    if lo <= top:
        x[:, lo:top + 1] = spec[:, lo:top + 1]
    x[:, 0] = x[:, 0].real                                      # c2r drops Im X[0]
    y = x[:, (q - torch.arange(q, device=dev)) % q].conj()      # conj X[Q-k]
    cy = c[:h, None] * y[:, None, :]                            # (n, P/2, Q)
    g = pre[:h] * (x[:, None] + cy) + 1j * (pre[h:] * (x[:, None] - cy))
    g[:, :, 0] = (x[:, 0].real * (1 + 1j))[:, None]
    z = torch.fft.ifft(g, dim=-1, norm="forward")               # unnormalised
    lag = torch.cat((z.real, z.imag), dim=1).transpose(1, 2).reshape(-1, wlen)   # n = r + P m
    if hi == wlen // 2:
        sign = 1.0 - 2.0 * (torch.arange(wlen, device=dev) % 2).to(torch.float32)
        lag = lag + spec[:, wlen // 2].real[:, None] * sign
    keep = torch.cat((lag[:, wlen - max_lag:], lag[:, :max_lag + 1]), dim=1)
    out[ii, jj] += keep * (1.0 / wlen)


def band_lag_add_cuda(cross: torch.Tensor, out: torch.Tensor, lead: int, lo: int,
                      hi: int, wlen: int, max_lag: int) -> None:
    """Launch ``csrc/band_lag_add.cu`` on PyTorch's current stream; same
    contract as :func:`band_lag_add_plain` for contiguous CUDA tensors."""
    global launches
    from das_diff_veh_tpu_torch import kernels

    if not (cross.is_cuda and out.is_cuda):
        raise ValueError(f"band_lag_add kernel takes CUDA tensors, got cross-spectra on "
                         f"{cross.device} and the stack on {out.device}")
    _check(cross, out, lo, hi, wlen, max_lag)
    m, nb, nf = cross.shape
    if m > 65535:
        raise ValueError(f"band_lag_add kernel takes at most 65535 sources a launch, got {m}")
    q, _ = band_plan(wlen, lo, hi)
    tab = twiddle_table(wlen, q, cross.device)
    fn = kernels.function("band_lag_add", "band_lag_add", ctypes.c_int,
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                          + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(cross.device):       # the launch goes to the current card
        stream = torch.cuda.current_stream(cross.device).cuda_stream
        rc = fn(cross.data_ptr(), out.data_ptr(), tab.data_ptr(), m, nb, nf, lead,
                out.shape[1], max_lag, wlen, q, lo, hi, 1.0 / wlen, stream)
    if rc != 0:
        raise RuntimeError(f"band_lag_add kernel launch failed with CUDA error {rc}")
    launches += 1


def band_lag_add(cross: torch.Tensor, out: torch.Tensor, lead: int, lo: int, hi: int,
                 wlen: int, max_lag: int) -> None:
    """The banded finish over bins ``lo..hi`` (module docstring): the kernel
    on the card, the plain version on the CPU."""
    if cross.is_cuda:
        band_lag_add_cuda(cross, out, lead, lo, hi, wlen, max_lag)
    else:
        band_lag_add_plain(cross, out, lead, lo, hi, wlen, max_lag)


def pairs(m: int, nb: int, width: int, lead: int) -> int:
    """In-array pairs of one launch."""
    return sum(max(0, min(nb, i - lead + width) - max(0, i - lead)) for i in range(m))


def bytes_moved(m: int, nb: int, width: int, lead: int, lo: int, hi: int,
                max_lag: int) -> int:
    """Least bytes one launch must move: each in-array pair's ``hi-lo+1``
    complex64 band bins read once and its ``2*max_lag+1`` float32 stack
    row read and written once."""
    return pairs(m, nb, width, lead) * (8 * (hi - lo + 1) + 8 * (2 * max_lag + 1))


def flops(m: int, nb: int, width: int, lead: int, lo: int, hi: int, wlen: int,
          max_lag: int) -> int:
    """Real operations of one launch as the kernel computes them: a pair's
    ``wlen/2`` points of G (24 each: three complex products and the sums),
    ``P/2`` radix-2/4/8/16 ``Q``-point FFTs (``5 Q log2 Q`` each), 15
    complex products a thread in each radix-16 stage after the first, and 3
    a lag of the add."""
    q, p = band_plan(wlen, lo, hi)
    per_pair = (12 * wlen + p // 2 * 5 * q * int(math.log2(q))
                + (len(radices(q)) - 1) * (wlen // 32) * 15 * 6 + 3 * (2 * max_lag + 1))
    return pairs(m, nb, width, lead) * per_pair
