"""Device builds after the engine's warm-up, from its
``das_serve_steady_state_compiles`` gauge (``obs/build_events``)."""


def read(r):
    return r.counters.get("das_serve_steady_state_compiles")
