"""host.pivots_s: host seconds per call inside the program's `spasm/pivots`
ranges: the host's structural pivot search (pivots, native)."""
from benchmark import tracing


def read(rec):
    return tracing.range_s_per_call(rec, "spasm/pivots")
