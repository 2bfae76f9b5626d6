"""The runtime's ``compute`` span a chunk: ``process_chunk`` (the fused
chunk's replay) and the pull of its image to the host."""


def read(r):
    ms = r.span_ms("compute")
    return sum(ms) / len(ms) if ms else None
