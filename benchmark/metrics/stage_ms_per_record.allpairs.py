"""Host time a record spends being staged onto the card: the day stack's
``ambient_stage`` span on the loader thread (the pin and the copy on the
staging stream, waited for), the mean over the window's records."""


def read(r):
    ms = r.span_ms("ambient_stage")
    return sum(ms) / len(ms) if ms else None
