"""Share of the traced run's burst of back-to-back requests in which no
operation ran on the device, from ``torch.profiler``'s device activity:
the dispatcher's host work between replays, at capacity."""


def read(r):
    d = r.device
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
