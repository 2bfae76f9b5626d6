"""95th percentile of the engine's ``queue`` span: from ``submit`` to the
dispatcher taking the request."""

import numpy as np


def read(r):
    ms = r.span_ms("queue")
    return float(np.percentile(ms, 95)) if ms else None
