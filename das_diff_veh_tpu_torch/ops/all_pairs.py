"""All-pairs windowed cross-correlation (BASELINE config 4): the host side of
``das_diff_veh_tpu/ops/pallas_xcorr.py``.

In the frequency domain the all-pairs generalisation of the reference's
virtual-shot correlation is

    C[s, r, f] = (1/nwin) * sum_w  S[s, w, f] * conj(S[r, w, f])

followed by an irfft over f.  The record is streamed so that channel count
never bounds memory: ``src_chunk`` source rows at a time, each chunk finished
in the lag domain (irfft, zero-lag roll, lag trim, or a per-pair peak) before
the next starts, and the window axis accumulated ``win_block`` windows at a
time.

On the kernel path the cross-spectra come from ``ops.cross_spectra`` (kernel
B3, ``csrc/cross_spectra.cu``) and the peak finish is fused: the irfft runs
over ``lagmax_block`` receiver rows at a time and each slab reduces through
``ops.lag_absmax`` (kernel B4, ``csrc/lag_absmax.cu``), so the
(src_chunk, nall, wlen) lag cube never exists.  Without the kernels an
einsum ``"swf,rwf->srf"`` in the input's dtype computes the same window mean.
On a CPU tensor the kernel path runs the kernels' plain versions, the
counterpart of the JAX package's ``interpret=True``.

``precision="bf16"`` rounds both spectra's real and imaginary parts through
bfloat16 and sums in float32: on the kernel path B3 takes bf16 pairs (the
receiver side made once per call, the source side once per chunk), as the
JAX package's bf16 planes; the einsum path rounds both spectra and runs the
complex64 einsum.

Unlike the JAX package, the last source chunk and the last receiver block are
sliced, not padded; results per pair are unchanged.  The JAX entries'
``interpret`` and ``lag_tile_max`` are TPU tiling knobs and have no
counterpart here.
"""

from __future__ import annotations

from typing import Callable

import torch

from das_diff_veh_tpu_torch.device import resolve_device
from das_diff_veh_tpu_torch.ops.cross_spectra import cross_spectra, to_bf16_pairs
from das_diff_veh_tpu_torch.ops.lag_absmax import lag_absmax
from das_diff_veh_tpu_torch.ops.precision import bf16_round_complex, check_precision
from das_diff_veh_tpu_torch.ops.xcorr import sliding_windows

PALLAS_MIN_CH = 512      # below this many channels the einsum path is the default
WIN_BLOCK_AUTO = 48      # past this many windows the window axis streams in slabs
_WIN_BLOCK_DEFAULT = 32  # the slab size it streams in then
LAGMAX_BLOCK_DEFAULT = 512   # receiver rows per irfft + peak slab of the fused finish


def _resolve_win_block(nwin: int, win_block: int | None) -> int:
    """Validate and normalise ``win_block`` to a slab size in [1, nwin]."""
    if win_block is not None and win_block < 0:
        raise ValueError(f"win_block must be None or >= 0, got {win_block}")
    if not win_block:                   # None/0: stream only past the auto cap
        return _WIN_BLOCK_DEFAULT if nwin > WIN_BLOCK_AUTO else max(nwin, 1)
    return max(min(win_block, nwin), 1)


def _resolve_lagmax_block(nall: int, use_kernel: bool,
                          lagmax_block: int | None) -> int:
    """Normalise ``lagmax_block``: 0 turns the fused finish off, None fuses on
    the kernel path only, a positive value sets the receiver-block size."""
    if lagmax_block is not None and lagmax_block < 0:
        raise ValueError(f"lagmax_block must be None or >= 0, got {lagmax_block}")
    if lagmax_block is None:
        return min(LAGMAX_BLOCK_DEFAULT, nall) if use_kernel else 0
    return min(lagmax_block, nall)


def _decide_kernel(nch: int, use_kernel: bool | None, device: torch.device) -> bool:
    """``None``: the kernels for ``nch >= PALLAS_MIN_CH`` on the card, never
    on the CPU; otherwise what the caller asked for."""
    if use_kernel is None:
        return nch >= PALLAS_MIN_CH and device.type == "cuda"
    return use_kernel


def _window_spectra(data: torch.Tensor, wlen: int, overlap_ratio: float) -> torch.Tensor:
    """(nch, nt) record -> (nch, nwin, wlen//2+1) complex64 window spectra
    (float32 even for a float64 record, as in the JAX package)."""
    offset = int(wlen * (1.0 - overlap_ratio))
    wins = sliding_windows(data, wlen, offset)           # (nch, nwin, wlen)
    return torch.fft.rfft(wins.to(torch.float32), dim=-1).contiguous()


def _einsum_cross_spectra(src_wf: torch.Tensor, all_wf: torch.Tensor,
                          win_block: int, precision: str = "f32") -> torch.Tensor:
    """The path without a kernel: the window mean as an einsum per
    ``win_block`` slab plus a ragged tail, accumulated in the inputs' dtype
    (complex128 stays complex128) and divided by ``nwin`` at the end.
    ``"bf16"`` first rounds both spectra through bfloat16 (complex64 out)."""
    if precision == "bf16":
        src_wf, all_wf = bf16_round_complex(src_wf), bf16_round_complex(all_wf)
    nwin = src_wf.shape[1]

    def ein(s, a):
        return torch.einsum("swf,rwf->srf", s, a.conj())

    if win_block >= nwin:
        return ein(src_wf, all_wf) / nwin
    acc = torch.zeros((src_wf.shape[0], all_wf.shape[0], src_wf.shape[2]),
                      dtype=torch.promote_types(src_wf.dtype, all_wf.dtype),
                      device=src_wf.device)
    n_full = nwin // win_block
    for i in range(n_full):
        sl = slice(i * win_block, (i + 1) * win_block)
        acc = acc + ein(src_wf[:, sl], all_wf[:, sl])
    if nwin % win_block:
        acc = acc + ein(src_wf[:, n_full * win_block:], all_wf[:, n_full * win_block:])
    return acc / nwin


def _make_cross_fn(wf_all: torch.Tensor, use_kernel: bool, win_block: int,
                   precision: str = "f32") -> Callable[[torch.Tensor], torch.Tensor]:
    """``cross(src_rows) -> (m, nall, nf)`` window-mean cross-spectra against
    the fixed receiver set ``wf_all``; the receiver side is made once, not
    once per source chunk: contiguous complex64, or bf16 pairs in the bf16
    tier."""
    if not use_kernel:
        return lambda src_rows: _einsum_cross_spectra(src_rows, wf_all, win_block,
                                                      precision)
    if precision == "bf16":
        prep = to_bf16_pairs
    else:
        def prep(wf):
            return wf.to(torch.complex64).contiguous()
    rcv = prep(wf_all)
    nwin = rcv.shape[1]

    def cross(src_rows):
        return cross_spectra(prep(src_rows), rcv, nwin, win_block)

    return cross


def _fused_peak_finish(cross: torch.Tensor, wlen: int, rcv_block: int) -> torch.Tensor:
    """(m, nall, nf) cross-spectra -> (m, nall) peak |xcorr| without the
    (m, nall, wlen) lag cube: the irfft runs ``rcv_block`` receiver rows at a
    time and each slab reduces through ``lag_absmax`` before the next slab's
    transform starts.  The last block is sliced, not padded."""
    m, nall, _ = cross.shape
    parts = []
    for r0 in range(0, nall, rcv_block):
        lag = torch.fft.irfft(cross[:, r0:r0 + rcv_block], n=wlen, dim=-1)
        nb = lag.shape[1]
        parts.append(lag_absmax(lag.reshape(m * nb, wlen)).reshape(m, nb))
    return torch.cat(parts, dim=1)


def _chunked(wf: torch.Tensor, src_chunk: int,
             finish: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Map ``finish`` over ``src_chunk``-row chunks of ``wf`` into one
    preallocated result; the last chunk is sliced, not padded."""
    nch = wf.shape[0]
    if nch <= src_chunk:
        return finish(wf)
    out = None
    for i0 in range(0, nch, src_chunk):
        part = finish(wf[i0:i0 + src_chunk])
        if out is None:
            out = part.new_empty((nch, *part.shape[1:]))
        out[i0:i0 + part.shape[0]] = part
    return out


def xcorr_all_pairs(data, wlen: int, overlap_ratio: float = 0.5,
                    lag_keep: int | None = None, src_chunk: int = 128,
                    use_kernel: bool | None = None, win_block: int | None = None,
                    precision: str = "f32", device=None) -> torch.Tensor:
    """All-pairs lag-domain xcorr of an (nch, nt) record on ``device``
    (``None`` = the card), zero lag centred: (nch, nch, wlen) float32, or
    the ``2*lag_keep+1`` lags around zero lag.

    Source rows are processed ``src_chunk`` at a time; each chunk's spectra
    are finished (irfft, roll, trim) before the next chunk starts.
    ``win_block`` streams the window axis (automatic past ``WIN_BLOCK_AUTO``
    windows).  ``use_kernel``: None = kernel B3 for ``nch >= 512`` on the
    card, True = B3 (its plain version on the CPU), False = the einsum.
    ``precision``: ``"f32"`` or ``"bf16"`` (module docstring)."""
    dev = resolve_device(device)
    wf = _window_spectra(torch.as_tensor(data).to(dev), wlen, overlap_ratio)
    use_k = _decide_kernel(wf.shape[0], use_kernel, dev)
    wb = _resolve_win_block(wf.shape[1], win_block)
    check_precision(precision)
    cross = _make_cross_fn(wf, use_k, wb, precision)
    mid = wlen // 2
    sl = slice(0, wlen) if lag_keep is None else slice(mid - lag_keep, mid + lag_keep + 1)

    def finish(src_rows):
        c = torch.fft.irfft(cross(src_rows), n=wlen, dim=-1)
        return torch.roll(c, mid, dims=-1)[..., sl]

    return _chunked(wf, src_chunk, finish)


def xcorr_all_pairs_peak(data, wlen: int, overlap_ratio: float = 0.5,
                         src_chunk: int = 64, use_kernel: bool | None = None,
                         win_block: int | None = None,
                         lagmax_block: int | None = None, precision: str = "f32",
                         device=None) -> torch.Tensor:
    """Per-pair peak |xcorr| over all lags of an (nch, nt) record on
    ``device`` (``None`` = the card): (nch, nch) float32.

    Per chunk of ``src_chunk`` source rows: cross-spectra, irfft, lag-axis
    max; nothing larger than (src_chunk, nch, nf) complex64 exists at once.
    ``use_kernel``, ``win_block`` and ``precision`` as in :func:`xcorr_all_pairs`;
    ``lagmax_block`` as in :func:`peak_from_spectra`."""
    dev = resolve_device(device)
    wf = _window_spectra(torch.as_tensor(data).to(dev), wlen, overlap_ratio)
    use_k = _decide_kernel(wf.shape[0], use_kernel, dev)
    return peak_from_spectra(wf, wf, wlen, src_chunk, use_k, win_block=win_block,
                             lagmax_block=lagmax_block, precision=precision,
                             device=dev)


def peak_from_spectra(wf_src, wf_all, wlen: int, src_chunk: int, use_kernel: bool,
                      win_block: int | None = None, lagmax_block: int | None = None,
                      precision: str = "f32", device=None) -> torch.Tensor:
    """Peak |xcorr| of every ``wf_src`` row against every ``wf_all`` row,
    (nsrc, nall), from (n, nwin, nf) window spectra moved to ``device``
    (``None`` = the card).  Split out so that a sharded caller can hand each
    device its own source rows while the receiver side stays whole.

    ``lagmax_block``: None = the fused finish on the kernel path (the
    einsum path keeps the unfused finish, its exact reference), 0 = the
    unfused finish, > 0 = the fused finish with that many receiver rows per
    slab.  Negative ``win_block`` or ``lagmax_block`` raises ``ValueError``."""
    dev = resolve_device(device)
    wf_src, wf_all = torch.as_tensor(wf_src).to(dev), torch.as_tensor(wf_all).to(dev)
    wb = _resolve_win_block(wf_src.shape[1], win_block)
    lb = _resolve_lagmax_block(wf_all.shape[0], use_kernel, lagmax_block)
    check_precision(precision)
    cross = _make_cross_fn(wf_all, use_kernel, wb, precision)

    def finish(src_rows):
        c = cross(src_rows)
        if lb:
            return _fused_peak_finish(c, wlen, lb)
        return torch.fft.irfft(c, n=wlen, dim=-1).abs().amax(dim=-1)

    return _chunked(wf_src, src_chunk, finish)
