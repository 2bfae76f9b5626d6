"""Share of the profiled records (at least 3, back to back in the closed
loop) in which no operation ran on the device, from ``torch.profiler``'s
device activity."""


def read(r):
    d = r.device
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
