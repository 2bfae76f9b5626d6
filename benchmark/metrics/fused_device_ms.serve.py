"""Device busy time a request, from ``torch.profiler`` over the traced
run's burst of requests that the dispatcher runs back to back, as it does
at capacity (``harness/systems/imaging.py``, ``_profile_burst``)."""


def read(r):
    d = r.device
    if d is None or r.profiled_units <= 0:
        return None
    return 1e3 * d.busy_s / r.profiled_units
