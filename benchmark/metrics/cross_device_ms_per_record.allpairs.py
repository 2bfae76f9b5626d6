"""Device time of kernel B3 (``csrc/cross_spectra.cu``) a record, from
``torch.profiler``'s kernels by name over the profiled records, which the
harness starts and stops between records."""

B3 = "cross_spectra_kernel"


def read(r):
    d = r.device
    if d is None or r.profiled_units <= 0:
        return None
    s = d.seconds(lambda name: B3 in name)
    return 1e3 * s / r.profiled_units if s > 0 else None
