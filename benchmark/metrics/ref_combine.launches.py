"""ref_combine.launches: kernel launches per call that the host made
inside the program's `spasm/ref_combine` ranges (runtime calls whose
correlation id names a kernel, not a copy or fill, in the device trace):
one a chunk of rows formed where kernel B12 takes the combine (d >= 3),
about nine a slot where the torch loop does (d = 2)."""
from benchmark import spans


def read(rec):
    if not spans.host_spans(rec, "spasm/ref_combine") or not rec["ncalls"]:
        return None
    n = len(spans.launched_in(rec, "spasm/ref_combine")
            & spans.kernel_ids(rec))
    return n / rec["ncalls"]
