"""ref_combine.device_s: device seconds per call of the work launched
inside the program's `spasm/ref_combine` ranges (dense/reduced.py
`ReducedBasis._form_chunk`: the weighted sum of the referenced R rows
that forms each chunk of a block, kernel B12 at d >= 3, the torch slot
loop at d = 2); launches matched to device events by correlation id on
the range's thread."""
from benchmark import spans


def read(rec):
    if not spans.host_spans(rec, "spasm/ref_combine") or not rec["ncalls"]:
        return None
    return spans.device_us(rec, spans.launched_in(rec, "spasm/ref_combine")) \
        / 1e6 / rec["ncalls"]
