"""panel_steps.launches: kernel launches per call that the host made
inside the program's `spasm/panel_steps` ranges (runtime calls whose
correlation id names a kernel, not a copy or fill, in the device trace):
the count at the host-device boundary of the d >= 3 panels' loops of
small torch ops (dense/elim.panel_steps)."""
from benchmark import spans


def read(rec):
    if not spans.host_spans(rec, "spasm/panel_steps") or not rec["ncalls"]:
        return None
    n = len(spans.launched_in(rec, "spasm/panel_steps")
            & spans.kernel_ids(rec))
    return n / rec["ncalls"]
