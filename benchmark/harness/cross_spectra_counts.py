"""Operations, bytes and the roofline bound of kernel B3
(``das_diff_veh_tpu_torch/csrc/cross_spectra.cu``) in the ambient day
stack, counted from the work that the stack's output needs, whatever
implements it.

The configuration fixes the launches: one a chunk of ``src_chunk`` source
rows, against the receiver rows within ``max_offset`` of the chunk, clipped
to the array, so that the last, partial chunk and the clipped bands count
less.  Within a launch the output needs:

- Bins: with ``whiten`` true only the whitening band's bins, ceil(f_lo *
  wlen / fs) to floor(f_hi * wlen / fs) (bins 9-204 of 2049 for DASH):
  whitening zeroes every other bin, and the finish reads the band alone.
  Without whitening every bin, ``wlen // 2 + 1``.
- Pairs: each source with the receivers within ``max_offset`` of it inside
  the array (601 a source away from the ends), not the whole rectangle of
  the chunk's rows by its receiver band.

Each launch is counted from ``m`` source rows, ``nall`` receiver rows,
``npairs`` needed pairs, ``nwin`` windows and ``nb`` bins, complex64:

- Operations: 8 real float32 operations a complex multiply-add, one a
  needed pair, window and bin.
- Bytes: the receiver band's spectra over the bins read once (the source
  rows lie inside the band), and one complex64 window mean written for each
  needed pair and bin.

The bound of a launch is the larger of its operations at 67 TFLOP/s (an
H100 SXM's float32 rate outside the tensor cores) and its bytes at 3.35 TB/s
(its HBM), the data sheet's peaks at 700 W.  A full DASH launch (64 x 664
rows, 38,464 pairs, 13 windows, 196 bins) moves 73.85 MB: 0.022 ms, bound by
its bytes; a record's 137 launches come to about 3 ms.
"""

from __future__ import annotations

import math

PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
COMPLEX64 = 8


def band_bins(cfg: dict) -> tuple:
    """``(lo, hi)``: the first and last rfft bin the stack's output depends
    on (module docstring)."""
    wlen, fs = int(cfg["wlen"]), float(cfg["fs_hz"])
    if not cfg["whiten"]:
        return 0, wlen // 2
    f_lo, f_hi = map(float, cfg["band_hz"])
    return max(math.ceil(f_lo * wlen / fs), 0), min(math.floor(f_hi * wlen / fs), wlen // 2)


def launches(nch: int, src_chunk: int, max_offset: int) -> list:
    """``(m, nall, npairs)`` of every launch over one record: source rows,
    receiver rows of the clipped band, and the pairs within ``max_offset``
    inside the array."""
    out = []
    for s0 in range(0, nch, src_chunk):
        s1 = min(s0 + src_chunk, nch)
        r0, r1 = max(s0 - max_offset, 0), min(s1 + max_offset, nch)
        npairs = sum(min(s + max_offset, nch - 1) - max(s - max_offset, 0) + 1
                     for s in range(s0, s1))
        out.append((s1 - s0, r1 - r0, npairs))
    return out


def flops(npairs: int, nwin: int, nb: int) -> int:
    return 8 * npairs * nwin * nb


def bytes_moved(nall: int, npairs: int, nwin: int, nb: int) -> int:
    return COMPLEX64 * nall * nwin * nb + COMPLEX64 * npairs * nb


def bound_s(nall: int, npairs: int, nwin: int, nb: int) -> float:
    return max(flops(npairs, nwin, nb) / PEAK_FLOPS,
               bytes_moved(nall, npairs, nwin, nb) / PEAK_BYTES_PER_S)


def record_shape(cfg: dict) -> tuple:
    """``(nwin, nb)`` of one record of the configuration ``cfg``: its
    windows and the bins its output needs."""
    nt = int(round(float(cfg["record_s"]) * float(cfg["fs_hz"])))
    wlen = int(cfg["wlen"])
    step = int(wlen * (1.0 - float(cfg["overlap_ratio"])))
    lo, hi = band_bins(cfg)
    return (nt - wlen) // step + 1, hi - lo + 1


def record_launches(cfg: dict) -> list:
    """:func:`launches` of one record of the configuration ``cfg``."""
    return launches(int(cfg["channels"]), int(cfg["src_chunk"]), int(cfg["max_offset"]))


def record_bound_s(cfg: dict) -> float:
    """The least time B3 could take over one record, launch by launch."""
    nwin, nb = record_shape(cfg)
    return sum(bound_s(nall, npairs, nwin, nb) for _, nall, npairs in record_launches(cfg))
