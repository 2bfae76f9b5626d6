"""Device time a record of the day stack's band spectra sent card to card:
the program's ``ambient_scatter`` device blocks (one on each card sent to,
from the spectra's readiness to the rows' landing; CUDA events on the
spans' clock), summed by the spans' ``record`` key over the cards, the mean
over the records of the traced window before its profile.  None where the
run kept no device timeline or the stack sent nothing."""


def read(r):
    per: dict = {}
    for s in getattr(r, "device_spans", None) or []:
        if s["name"] == "ambient_scatter":
            key = s["args"].get("record")
            per[key] = per.get(key, 0.0) + s["dur"]
    return sum(per.values()) / len(per) / 1e3 if per else None
