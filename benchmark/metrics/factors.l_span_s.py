"""factors.l_span_s: host seconds per call inside the program's
`spasm/factors_l` ranges: reading L to host CSR (LU.L: the dense
factor's copies, their sparsification and the COO-to-CSR build)."""
from benchmark import tracing


def read(rec):
    return tracing.range_s_per_call(rec, "spasm/factors_l")
