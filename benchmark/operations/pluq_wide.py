"""Operation `pluq_wide`: the `pluq` operation (a complete PLUQ, then the
rank, qinv, p, L and U read to the host) judged by a reference whose
products stay exact at every odd p <= 2^32 - 5 (reference_wide_lu.py).
The reference checks the rank against the configuration's stated rank
at the mix's prime, U's echelon form, L's structure and A X = L (U X)."""
import numpy as np

from benchmark import echelon

plant = echelon.plant


def call(prog, torch, A, opts, dev):
    return echelon.call(prog, torch, A, opts, dev, read_l=True)


def launch(prog, torch, A, opts, dev):
    echelon.launch(prog, torch, A, opts, dev)


def check(cell, inputs, kept, dev, torch):
    """`echelon.check` of the LU operation, with the wide product check:
    rank_gap, echelon_faults, l_faults and lu_residual for each kept
    call, in call order, each with the limit 0."""
    from benchmark import reference as ref
    from benchmark import reference_wide_lu as wide
    p, k = cell.prime, echelon.CHECK_VECTORS
    ref_rank = int(cell.config["ranks"][str(p)])
    verdicts = []
    for i, out in sorted(kept.items()):
        A = (inputs.indptr, inputs.indices, inputs.data(i))
        rng = np.random.default_rng([inputs.seed, 2, i + 1])
        E = ref.Echelon(*out["U"], out["r"], inputs.m, p, dev)
        got = {"rank_gap": abs(out["r"] - ref_rank),
               "echelon_faults": ref.echelon_faults(E, out["qinv"])}
        del E
        X = torch.as_tensor(rng.integers(0, p, (inputs.m, k)), device=dev)
        got["l_faults"] = ref.l_faults(*out["L"], out["p"], inputs.n,
                                       out["r"], p, dev)
        got["lu_residual"] = wide.lu_residual(A, out["L"], out["U"], X, p)
        verdicts.append({name: int(v) for name, v in got.items()})
    return verdicts
