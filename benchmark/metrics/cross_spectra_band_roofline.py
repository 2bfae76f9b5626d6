"""Kernel B3's share of its roofline in the day stack, counted on the work
the stack's output needs: the least time its launches over a record could
take (each launch's operations at 67 TFLOP/s or its bytes at 3.35 TB/s,
whichever is larger, over the whitening band's bins and the pairs within
``max_offset``: ``harness/cross_spectra_counts.py``) over B3's device time
a record, from ``torch.profiler`` over the profiled records, in percent.

The count is the same whatever B3 computes: a B3 that runs over every bin
of the window pays for bins the count leaves out and reads low, and one
that skips the bins whitening zeroes still reads under 100 %."""

from harness.cross_spectra_counts import record_bound_s

B3 = "cross_spectra_kernel"


def read(r):
    d = r.device
    if d is None or r.profiled_units <= 0 or "src_chunk" not in r.config:
        return None
    s = d.seconds(lambda name: B3 in name)
    return 100.0 * record_bound_s(r.config) * r.profiled_units / s if s > 0 else None
