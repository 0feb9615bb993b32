"""dense_finisher.trailing_inverse_s: host seconds per call inside the program's `spasm/trailing_inverse`
ranges: the dense finisher's trailing inverse (dense/elim.py)."""
from benchmark import tracing


def read(rec):
    return tracing.range_s_per_call(rec, "spasm/trailing_inverse")
