"""How long compute waited for the loader a chunk: the runtime's
``input_wait`` spans over the chunks computed."""


def read(r):
    n = len(r.span_ms("compute"))
    return sum(r.span_ms("input_wait")) / n if n else None
