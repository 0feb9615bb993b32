"""step_sweep.device_s: device seconds per call of the work launched
inside the program's `spasm/step_sweep` ranges (dense/rowrref.step_sweep,
the d >= 3 tiers' row sweep in torch ops); launches matched to device
events by correlation id on the range's thread."""
from benchmark import spans


def read(rec):
    if not spans.host_spans(rec, "spasm/step_sweep") or not rec["ncalls"]:
        return None
    return spans.device_us(rec, spans.launched_in(rec, "spasm/step_sweep")) \
        / 1e6 / rec["ncalls"]
