"""How far the busiest card of a day stack split over cards runs past the
others: for each record, the program's ``ambient_cross`` and
``ambient_finish`` device blocks summed by their ``card`` arg, the largest
card's sum over the mean of the cards' sums, less 1, in percent; the mean
over the records of the traced window before its profile.  None where the
run kept no device timeline or no record ran on more than one card."""


def read(r):
    per: dict = {}                      # record -> card -> microseconds
    for s in getattr(r, "device_spans", None) or []:
        if s["name"] in ("ambient_cross", "ambient_finish") and "card" in s["args"]:
            cards = per.setdefault(s["args"].get("record"), {})
            cards[s["args"]["card"]] = cards.get(s["args"]["card"], 0.0) + s["dur"]
    skews = []
    for cards in per.values():
        mean = sum(cards.values()) / len(cards)
        if len(cards) > 1 and mean > 0:
            skews.append(100.0 * (max(cards.values()) / mean - 1.0))
    return sum(skews) / len(skews) if skews else None
