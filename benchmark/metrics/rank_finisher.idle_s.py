"""rank_finisher.idle_s: seconds per call inside the program's
`spasm/finish_device` ranges in which no device event ran (the span
less the union of the device events clipped to it): the rank
finisher's host time that the card waits on."""
from benchmark import spans


def read(rec):
    if not spans.host_spans(rec, "spasm/finish_device") or not rec["ncalls"]:
        return None
    return spans.idle_us_inside(rec, "spasm/finish_device") / 1e6 \
        / rec["ncalls"]
