"""The runtime's ``compute`` span a record of the day stack:
``DayStack.add`` from the one-bit spectra to the wait until the record's
last band add is in the stack, the mean over the window's records."""


def read(r):
    ms = r.span_ms("compute")
    return sum(ms) / len(ms) if ms else None
