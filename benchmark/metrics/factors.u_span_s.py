"""factors.u_span_s: host seconds per call inside the program's
`spasm/factors_u` ranges: reading U to host CSR (LU.U: the device
blocks' copies, their sparsification, the topological levels and the
concatenation into one CSR)."""
from benchmark import tracing


def read(rec):
    return tracing.range_s_per_call(rec, "spasm/factors_u")
