"""Operations, bytes and the roofline bound of kernel B5
(``das_diff_veh_tpu_torch/csrc/band_lag_add.cu``), the day stack's banded
finish, counted from the work that the stack's output needs, whatever
implements it.

The launches are B3's (``harness/cross_spectra_counts.py``): one a chunk of
``src_chunk`` sources, each source with the receivers within
``max_offset`` of it inside the array (the needed pairs), over the bins the
output depends on (the whitening band's, else all).  For each needed pair
the finish turns its window-mean cross-spectrum into the ``2*max_lag+1``
lags nearest zero and adds them into the pair's row of the stack.

- Bytes: each needed pair's bins read once (complex64), and its stack row,
  ``2*max_lag+1`` float32, read and written once.  A full DASH launch
  (38,464 pairs, 196 bins, 2001 lags) moves 676.0 MB: 0.2018 ms.
- Operations: a pair's inverse real FFT of the window, 2.5 * wlen *
  log2(wlen) (half a complex FFT's 5 N log2 N), and a multiply and an add
  a kept lag (the 1/wlen scale and the add into the stack).  A full DASH
  launch is 4.88 GFLOP: 0.073 ms.  The kernel's own count of its band-pruned
  decomposition (``ops/band_lag_add.flops``) is 5.7 GFLOP; neither comes
  near the bytes, which bound every launch of the day stack.

The bound of a launch is the larger of the two at 67 TFLOP/s and 3.35 TB/s
(an H100 SXM's float32 rate outside the tensor cores and its HBM, the data
sheet's peaks at 700 W).
"""

from __future__ import annotations

import math

from harness.cross_spectra_counts import (COMPLEX64, PEAK_BYTES_PER_S, PEAK_FLOPS,
                                          record_launches, record_shape)

FLOAT32 = 4


def flops(npairs: int, wlen: int, max_lag: int) -> float:
    return npairs * (2.5 * wlen * math.log2(wlen) + 2 * (2 * max_lag + 1))


def bytes_moved(npairs: int, nb: int, max_lag: int) -> int:
    return npairs * (COMPLEX64 * nb + 2 * FLOAT32 * (2 * max_lag + 1))


def bound_s(npairs: int, nb: int, wlen: int, max_lag: int) -> float:
    return max(flops(npairs, wlen, max_lag) / PEAK_FLOPS,
               bytes_moved(npairs, nb, max_lag) / PEAK_BYTES_PER_S)


def record_bound_s(cfg: dict) -> float:
    """The least time B5 could take over one record, launch by launch."""
    _, nb = record_shape(cfg)
    wlen, max_lag = int(cfg["wlen"]), int(cfg["max_lag"])
    return sum(bound_s(npairs, nb, wlen, max_lag) for _, _, npairs in record_launches(cfg))
