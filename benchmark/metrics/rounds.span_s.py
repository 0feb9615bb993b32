"""rounds.span_s: host seconds per call inside the program's
`spasm/round` ranges: the round loop of echelonize (each round's
structural pivots, density estimate and sparse Schur complement)."""
from benchmark import tracing


def read(rec):
    return tracing.range_s_per_call(rec, "spasm/round")
