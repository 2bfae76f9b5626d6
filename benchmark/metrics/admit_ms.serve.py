"""Mean host time of ``ServingEngine.submit``, timed by the harness around
each call: the admission screen on the host and the enqueue."""


def read(r):
    ms = r.harness.get("submit_ms") or []
    return sum(ms) / len(ms) if ms else None
