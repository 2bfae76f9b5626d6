"""Dispatcher time a request: the engine's ``pad``, ``compute`` and
``unpad`` spans over the requests computed.  One dispatcher serves the
requests one after another, so above the engine's capacity this time sets
the requests served a second."""


def read(r):
    n = len(r.span_ms("compute"))
    return sum(r.span_ms("pad", "compute", "unpad")) / n if n else None
