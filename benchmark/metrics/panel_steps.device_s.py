"""panel_steps.device_s: device seconds per call of the work launched
inside the program's `spasm/panel_steps` ranges (dense/elim.panel_steps,
each panel's pivots and pivot-minor factors in torch ops: the d >= 3
dense LU's route in place of kernel B4); launches matched to device
events by correlation id on the range's thread."""
from benchmark import spans


def read(rec):
    if not spans.host_spans(rec, "spasm/panel_steps") or not rec["ncalls"]:
        return None
    return spans.device_us(rec, spans.launched_in(rec, "spasm/panel_steps")) \
        / 1e6 / rec["ncalls"]
