"""rank_finisher.span_s: host seconds per call inside the program's `spasm/finish_device`
ranges: the rank finisher (finish_device_dense)."""
from benchmark import tracing


def read(rec):
    return tracing.range_s_per_call(rec, "spasm/finish_device")
