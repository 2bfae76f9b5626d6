"""Device time of the day stack's finish a record: the program's
``ambient_finish`` device blocks (irfft, lag cut and band add, one a source
chunk; CUDA events on the spans' clock), summed by the spans' ``record``
key, the mean over the records of the traced window before its profile.
None where the run kept no device timeline."""


def read(r):
    per: dict = {}
    for s in getattr(r, "device_spans", None) or []:
        if s["name"] == "ambient_finish":
            key = s["args"].get("record")
            per[key] = per.get(key, 0.0) + s["dur"]
    return sum(per.values()) / len(per) / 1e3 if per else None
