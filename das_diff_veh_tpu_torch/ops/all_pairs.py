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

Unlike the JAX package, the last source chunk is sliced, not padded, for the
cross-spectra; the fused finish pads every irfft batch to one shape (see
``_fused_peak_finish``).  Results per pair are unchanged.  The JAX entries'
``interpret`` and ``lag_tile_max`` are TPU tiling knobs and have no
counterpart here.

The banded lag-domain product (:func:`add_banded`, under the ambient-noise
day stack of ``pipeline.ambient``) keeps only the pairs within ``max_offset`` rows of
each other and the lags within ``max_lag`` samples of zero, as a
(nch, 2*max_offset+1, 2*max_lag+1) gather per source; it goes beyond the JAX
package, whose lag-domain entry returns every pair.  Each chunk of source
rows is correlated against its own receiver band, a contiguous row slice of
the receiver spectra, clipped at the array's ends, so B3 runs as it is (a
pair's bits from B3 do not depend on the receiver set).  Where the spectra
carry a whitening band (``band``: every bin outside it zero, in a window the
kernel takes), each chunk's finish is ``ops.band_lag_add``: a band-pruned
inverse FFT a pair that adds its lags straight into the gather (a kernel on
the card), pairs past either end of the array skipped.  Without a band every irfft takes one batch
shape, (src_chunk, src_chunk + 2*max_offset): the band of a ragged or
clipped chunk is zero-padded to it, so that pairs past either end of the
array read 0 and a pair's bits do not depend on the chunk it falls in.
Each source's receivers are then taken out of the lag block as a strided
view, no copy, and added into the caller's gather with the irfft's 1/wlen
as the add's scale.
"""

from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Optional

import torch

from das_diff_veh_tpu_torch.device import resolve_device
from das_diff_veh_tpu_torch.ops import band_lag_add as bla
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


def _fused_peak_finish(cross: torch.Tensor, wlen: int, rcv_block: int,
                       src_rows: int) -> torch.Tensor:
    """(m, nall, nf) cross-spectra -> (m, nall) peak |xcorr| without the
    (m, nall, wlen) lag cube: the irfft runs ``rcv_block`` receiver rows at a
    time and each slab reduces through ``lag_absmax`` before the next slab's
    transform starts.

    Every irfft takes a (src_rows, rcv_block) batch: a ragged source chunk or
    receiver block is zero-padded to it and only its own peaks are kept.
    cuFFT picks its algorithm by the batch count (on an H100, a 4 x 452
    batch of 1024-point transforms rounds otherwise than a 64 x 512 one), and
    one pair's bits must not depend on the chunk or block it falls in: the
    ring (``parallel.allpairs``) cuts the same pairs into other chunks."""
    m, nall, _ = cross.shape
    parts = []
    for r0 in range(0, nall, rcv_block):
        blk = cross[:, r0:r0 + rcv_block]
        nb = blk.shape[1]
        if (m, nb) != (src_rows, rcv_block):
            blk = torch.nn.functional.pad(blk, (0, 0, 0, rcv_block - nb, 0, src_rows - m))
        lag = torch.fft.irfft(blk, n=wlen, dim=-1)
        parts.append(lag_absmax(lag.reshape(src_rows * rcv_block, wlen))
                     .reshape(src_rows, rcv_block)[:m, :nb])
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

    # the fused finish's batch: src_chunk sources x the block asked for, the
    # same for a whole record and for a ring's shard of it
    block = LAGMAX_BLOCK_DEFAULT if lagmax_block is None else lagmax_block

    def finish(src_rows):
        c = cross(src_rows)
        if lb:
            return _fused_peak_finish(c, wlen, block, src_chunk)
        return torch.fft.irfft(c, n=wlen, dim=-1).abs().amax(dim=-1)

    return _chunked(wf_src, src_chunk, finish)


def band_schedule(nch: int, src_chunk: int, max_offset: int,
                  chunks: range | None = None) -> list:
    """``(s0, s1, r0, r1)`` of every chunk of the banded entry, or of the
    chunks numbered ``chunks`` (a block of them: a shard of the day
    stack): source rows ``s0:s1`` against receiver rows ``r0:r1``, the
    ``max_offset`` rows on either side of the chunk clipped to the array."""
    if src_chunk < 1 or max_offset < 0:
        raise ValueError(f"src_chunk must be >= 1 and max_offset >= 0, got {src_chunk} "
                         f"and {max_offset}")
    starts = range(0, nch, src_chunk)
    if chunks is not None:
        starts = starts[chunks.start:chunks.stop]
    return [(s0, min(s0 + src_chunk, nch), max(s0 - max_offset, 0),
             min(s0 + src_chunk + max_offset, nch)) for s0 in starts]


def _banded_finish(cross: torch.Tensor, out: torch.Tensor, s0: int, r0: int, wlen: int,
                   max_offset: int, max_lag: int, src_chunk: int, band=None) -> None:
    """Add (m, nb, nf) cross-spectra of source rows ``s0:s0+m`` against
    receiver rows ``r0:r0+nb`` into ``out`` (m, 2*max_offset+1,
    2*max_lag+1) in the lag domain (module docstring): with ``band``, by
    ``band_lag_add`` over its bins, otherwise by the irfft."""
    m, nb, _ = cross.shape
    lead = r0 - (s0 - max_offset)          # band rows clipped below row 0
    if band is not None:
        bla.band_lag_add(cross.contiguous(), out, lead, band[0], band[1], wlen, max_lag)
        return
    width = src_chunk + 2 * max_offset
    if (m, nb) != (src_chunk, width):
        cross = torch.nn.functional.pad(cross, (0, 0, lead, width - nb - lead,
                                                0, src_chunk - m))
    lag = torch.fft.irfft(cross, n=wlen, dim=-1, norm="forward")   # unscaled
    # source i's receivers are band rows i .. i + 2*max_offset
    diag = lag.as_strided((m, 2 * max_offset + 1, wlen),
                          (lag.stride(0) + lag.stride(1), lag.stride(1), lag.stride(2)),
                          lag.storage_offset())
    scale = 1.0 / wlen
    out[..., :max_lag].add_(diag[..., wlen - max_lag:], alpha=scale)   # lags -L .. -1
    out[..., max_lag:].add_(diag[..., :max_lag + 1], alpha=scale)      # lags 0 .. L


def _no_block(name: str):
    return contextlib.nullcontext()


class BandShard:
    """One device's part of the stack :func:`add_banded` adds into, with
    what its chunks take made once: ``out`` holds the stack rows from
    ``out_row0`` on of ``chunks`` (a contiguous block of
    :func:`band_schedule`'s chunks), on one device; :attr:`spectra` holds
    the record's spectra rows from ``row0`` on, on that device (None:
    ``add_banded``'s ``wf``); ``block`` as ``add_banded``'s.  Each chunk's
    stack rows are a view made here, and its cross-spectra a view of one
    buffer of the shard's, made at its first record (again for another
    number of bins), so that a record's launches make no tensor a chunk."""

    def __init__(self, out: torch.Tensor, chunks: list, out_row0: int = 0, row0: int = 0,
                 block: Callable[[str], ContextManager] = _no_block):
        self.out, self.chunks, self.row0, self.block = out, list(chunks), row0, block
        self.rows = [out[s0 - out_row0:s1 - out_row0] for s0, s1, _, _ in self.chunks]
        self.spectra: Optional[torch.Tensor] = None
        self._cross: tuple = (None, [])

    def cross(self, nf: int) -> list:
        """A contiguous (m, nb, nf) complex64 view a chunk, all of one
        buffer: a chunk's cross-spectra are read by its finish before the
        next chunk's are written, in the order of the device's stream."""
        if self._cross[0] != nf:
            size = max((s1 - s0) * (r1 - r0) for s0, s1, r0, r1 in self.chunks) * nf
            buf = torch.empty(size, dtype=torch.complex64, device=self.out.device)
            self._cross = (nf, [buf[:(s1 - s0) * (r1 - r0) * nf].view(s1 - s0, r1 - r0, nf)
                                for s0, s1, r0, r1 in self.chunks])
        return self._cross[1]


def add_banded(wf: torch.Tensor, out, wlen: int, max_offset: int, max_lag: int,
               src_chunk: int = 64, use_kernel: bool = True,
               block: Callable[[str], ContextManager] = _no_block, band=None) -> None:
    """Add the banded lag-domain xcorr of (nch, nwin, nf) window spectra
    ``wf`` into ``out`` (nch, 2*max_offset+1, 2*max_lag+1) float32 on the
    same device: ``out[s, j, L + k]`` gains the window-mean correlation of
    source row ``s`` with receiver row ``s + j - max_offset`` at lag ``k``
    (0 for a receiver past either end of the array).  ``use_kernel``: B3
    (its plain version on the CPU) or the einsum.  ``block(name)`` wraps
    each chunk's ``"cross"`` and ``"finish"`` work (the pipeline's device
    blocks).  ``band``: ``(lo, hi)`` where every bin of ``wf`` outside
    ``lo..hi`` is zero (whitened spectra), in a window ``band_lag_add``
    takes: the finish then runs over the band alone.

    ``out`` may instead be a list of :class:`BandShard`: a stack split by
    blocks of chunks over devices (``pipeline.ambient.DayStack``).  Their
    chunks are enqueued in turn, the first of each shard, then the second
    of each, and so on, so that every device starts at once; each chunk
    runs on its shard's device (the launches switch to it) and is wrapped
    in its shard's ``block``.  A chunk's arithmetic is that of the whole
    stack."""
    nch, nwin, nf = wf.shape
    if 2 * max_lag + 1 > wlen:
        raise ValueError(f"max_lag={max_lag} keeps more than the {wlen} lags of a window")
    if isinstance(out, torch.Tensor):
        if out.shape != (nch, 2 * max_offset + 1, 2 * max_lag + 1):
            raise ValueError(f"out must be {(nch, 2 * max_offset + 1, 2 * max_lag + 1)}, "
                             f"got {tuple(out.shape)}")
        out = [BandShard(out, band_schedule(nch, src_chunk, max_offset), block=block)]
    wb = _resolve_win_block(nwin, None)
    shards = [(s, wf if s.spectra is None else s.spectra, s.cross(nf) if use_kernel else None)
              for s in out]
    for i in range(max(len(s.chunks) for s in out)):
        for shard, spectra, cross in shards:
            if i >= len(shard.chunks):
                continue
            s0, s1, r0, r1 = shard.chunks[i]
            a = shard.row0
            src, rcv = spectra[s0 - a:s1 - a], spectra[r0 - a:r1 - a]
            with shard.block("cross"):
                if use_kernel:
                    c = cross_spectra(src, rcv, nwin, wb, out=cross[i])
                else:
                    c = _einsum_cross_spectra(src, rcv, wb)
            with shard.block("finish"):
                _banded_finish(c, shard.rows[i], s0, r0, wlen, max_offset, max_lag, src_chunk,
                               band)
