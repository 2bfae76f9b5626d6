"""Spectra sent card to card a record by a day stack split over cards: the
``bytes`` arg of the program's ``ambient_scatter`` span (main thread, one a
record), in MB of 10^6 bytes, the mean over the window's records.  None
where the program sent nothing card to card."""


def read(r):
    sent = [s["args"]["bytes"] for s in r.spans
            if s["name"] == "ambient_scatter" and "bytes" in s["args"]]
    return sum(sent) / len(sent) / 1e6 if sent else None
