"""Operation `rank_wide`: the `rank` operation (the rank tool's call,
`echelonize` with the mix's options, then the rank, qinv and U read to
the host) judged by the reference whose products stay exact at every
odd p <= 2^32 - 5 (reference_wide.py).  The reference checks the rank
against the configuration's stated rank at the mix's prime, U's echelon
form and that rowspan(A) lies in rowspan(U)."""
import numpy as np

from benchmark import echelon

plant = echelon.plant


def call(prog, torch, A, opts, dev):
    return echelon.call(prog, torch, A, opts, dev, read_l=False)


def launch(prog, torch, A, opts, dev):
    echelon.launch(prog, torch, A, opts, dev)


def check(cell, inputs, kept, dev, torch):
    """`echelon.check` of the rank operation, with the wide span check:
    rank_gap, echelon_faults and span_residual for each kept call, in
    call order, each with the limit 0."""
    from benchmark import reference as ref
    from benchmark import reference_wide as wide
    p, k = cell.prime, echelon.CHECK_VECTORS
    ref_rank = int(cell.config["ranks"][str(p)])
    verdicts = []
    for i, out in sorted(kept.items()):
        A = (inputs.indptr, inputs.indices, inputs.data(i))
        rng = np.random.default_rng([inputs.seed, 2, i + 1])
        E = ref.Echelon(*out["U"], out["r"], inputs.m, p, dev)
        got = {"rank_gap": abs(out["r"] - ref_rank),
               "echelon_faults": ref.echelon_faults(E, out["qinv"])}
        Y = torch.as_tensor(rng.integers(0, p, (inputs.n, k)), device=dev)
        got["span_residual"] = (wide.span_residual(E, *A, Y)
                                if got["echelon_faults"] == 0
                                else inputs.m * k)
        del E
        verdicts.append({name: int(v) for name, v in got.items()})
    return verdicts
