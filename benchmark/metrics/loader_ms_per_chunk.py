"""Host loader time a chunk: the runtime's ``read``, ``preprocess`` (the
savgol pre-smooth) and ``device_put`` spans over the chunks computed."""


def read(r):
    n = len(r.span_ms("compute"))
    return sum(r.span_ms("read", "preprocess", "device_put")) / n if n else None
