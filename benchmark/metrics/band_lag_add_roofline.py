"""Kernel B5's share of its roofline in the day stack: the least time its
launches over a record could take (each launch's operations at 67 TFLOP/s
or its bytes at 3.35 TB/s, whichever is larger, over the pairs within
``max_offset`` and the whitening band's bins: ``harness/band_lag_add_counts.py``)
over B5's device time a record, from ``torch.profiler`` over the profiled
records, in percent.  None where B5 did not run (spectra not whitened: the
finish is the irfft)."""

from harness.band_lag_add_counts import record_bound_s

B5 = "band_lag_add_kernel"


def read(r):
    d = r.device
    if d is None or r.profiled_units <= 0 or "src_chunk" not in r.config:
        return None
    s = d.seconds(lambda name: B5 in name)
    return 100.0 * record_bound_s(r.config) * r.profiled_units / s if s > 0 else None
