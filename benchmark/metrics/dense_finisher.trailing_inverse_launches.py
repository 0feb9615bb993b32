"""dense_finisher.trailing_inverse_launches: kernel launches per call
that the host issued inside the program's `spasm/trailing_inverse`
ranges (runtime calls whose correlation id names a kernel, not a copy
or fill, in the device trace): the count at the host-device boundary of
the trailing inverse's loop of small torch ops (dense/elim.py)."""
from benchmark import spans


def read(rec):
    if not spans.host_spans(rec, "spasm/trailing_inverse") \
            or not rec["ncalls"]:
        return None
    n = len(spans.launched_in(rec, "spasm/trailing_inverse")
            & spans.kernel_ids(rec))
    return n / rec["ncalls"]
