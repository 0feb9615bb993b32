"""dense_finisher.span_s: host seconds per call inside the program's `spasm/finish_dense`
ranges: the dense finisher (finish_dense)."""
from benchmark import tracing


def read(rec):
    return tracing.range_s_per_call(rec, "spasm/finish_dense")
