"""Operations, bytes and the roofline bound of kernel B3
(``das_diff_veh_tpu_torch/csrc/cross_spectra.cu``) as the ambient day stack
launches it: one launch a chunk of ``src_chunk`` source rows, against the
receiver rows within ``max_offset`` of the chunk, clipped to the array, so
that the last, partial chunk and the clipped bands count less.

Each launch is counted from its own shapes: ``m`` source rows, ``nall``
receiver rows, ``nwin`` windows, ``nf`` bins, complex64.

- Operations: 8 real float32 operations a complex multiply-add, one a pair,
  window and bin.
- Bytes: each input byte read once and each output byte written once.  The
  source rows lie inside the receiver band, so the input is the band's
  spectra; the output is the (m, nall, nf) complex64 window mean.

The bound of a launch is the larger of its operations at 67 TFLOP/s (an
H100 SXM's float32 rate outside the tensor cores) and its bytes at 3.35 TB/s
(its HBM), the data sheet's peaks at 700 W.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
COMPLEX64 = 8


def launches(nch: int, src_chunk: int, max_offset: int) -> list:
    """``(m, nall)`` of every launch over one record."""
    out = []
    for s0 in range(0, nch, src_chunk):
        s1 = min(s0 + src_chunk, nch)
        r0, r1 = max(s0 - max_offset, 0), min(s1 + max_offset, nch)
        out.append((s1 - s0, r1 - r0))
    return out


def flops(m: int, nall: int, nwin: int, nf: int) -> int:
    return 8 * m * nall * nwin * nf


def bytes_moved(m: int, nall: int, nwin: int, nf: int) -> int:
    return COMPLEX64 * nall * nwin * nf + COMPLEX64 * m * nall * nf


def bound_s(m: int, nall: int, nwin: int, nf: int) -> float:
    return max(flops(m, nall, nwin, nf) / PEAK_FLOPS,
               bytes_moved(m, nall, nwin, nf) / PEAK_BYTES_PER_S)


def record_shape(cfg: dict) -> tuple:
    """``(nwin, nf)`` of one record of the configuration ``cfg``."""
    nt = int(round(float(cfg["record_s"]) * float(cfg["fs_hz"])))
    wlen = int(cfg["wlen"])
    step = int(wlen * (1.0 - float(cfg["overlap_ratio"])))
    return (nt - wlen) // step + 1, wlen // 2 + 1


def record_bound_s(cfg: dict) -> float:
    """The least time B3 could take over one record, launch by launch."""
    nwin, nf = record_shape(cfg)
    return sum(bound_s(m, nall, nwin, nf)
               for m, nall in launches(int(cfg["channels"]), int(cfg["src_chunk"]),
                                       int(cfg["max_offset"])))
