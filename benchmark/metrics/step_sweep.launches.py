"""step_sweep.launches: kernel launches per call that the host made
inside the program's `spasm/step_sweep` ranges (runtime calls whose
correlation id names a kernel, not a copy or fill, in the device trace):
the count at the host-device boundary of the wide row sweep's loop of
small torch ops (dense/rowrref.step_sweep)."""
from benchmark import spans


def read(rec):
    if not spans.host_spans(rec, "spasm/step_sweep") or not rec["ncalls"]:
        return None
    n = len(spans.launched_in(rec, "spasm/step_sweep")
            & spans.kernel_ids(rec))
    return n / rec["ncalls"]
