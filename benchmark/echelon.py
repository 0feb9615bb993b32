"""What the echelonize operations (operations/rank.py, operations/pluq.py)
share: the call with its answers read to the host, the faults planted
where the answers are made, and the reference's verdict on them."""
from __future__ import annotations

import time

import numpy as np

CHECK_VECTORS = 2        # random vectors per check (error <= p^-2)


def launch(prog, torch, A, opts, dev):
    """The call's device work alone: echelonize, then a synchronize; no
    answer read (the set-up's warm-up and the traced run's replay)."""
    fact = prog.echelonize(A, opts, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return fact


def call(prog, torch, A, opts, dev, read_l: bool):
    """echelonize, then r, qinv and U (with read_l also p and L) read to
    the host and a synchronize: (answers, {"read": seconds of the read})."""
    fact = prog.echelonize(A, opts, device=dev)
    t0 = time.perf_counter()
    U = fact.U
    out = {"r": int(fact.r), "qinv": np.array(fact.qinv),
           "U": (U.indptr, U.indices, U.data), "rounds": fact.rounds}
    if read_l:
        L = fact.L
        out["L"] = (L.indptr, L.indices, L.data)
        out["p"] = np.array(fact.p)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, {"read": time.perf_counter() - t0}


def plant(out: dict, fault: str, p: int) -> dict:
    """A fault in the answers where they are made: `drop`, U's last row
    and a rank one short; `alter`, one value of U's longest row moved."""
    if fault not in ("drop", "alter"):
        raise ValueError(f"echelon answers have no fault {fault!r}")
    if out["r"] == 0:
        return out
    ip, ix, dv = out["U"]
    if fault == "drop":
        last = int(ip[-2])
        out = dict(out, r=out["r"] - 1, U=(ip[:-1], ix[:last], dv[:last]))
        out["qinv"] = np.where(out["qinv"] == out["r"], -1, out["qinv"])
        return out
    dv = np.array(dv)
    lens = np.diff(ip)
    k = int(np.argmax(lens))
    j = int(ip[k]) + (1 if lens[k] > 1 else 0)
    dv[j] = (int(dv[j]) + 1 + p // 2) % p - p // 2
    return dict(out, U=(ip, ix, dv))


def reference_rank(cell, inputs, dev, torch) -> int:
    """The configuration's stated rank at this prime, or the plain dense
    rank of call 0's input."""
    from . import reference as ref
    stated = cell.config.get("ranks", {}).get(str(cell.prime))
    if stated is not None:
        return int(stated)
    M = torch.zeros((inputs.n, inputs.m), dtype=torch.int64, device=dev)
    rows = torch.as_tensor(inputs.rows, device=dev)
    cols = torch.as_tensor(inputs.indices.astype(np.int64), device=dev)
    M[rows, cols] = torch.as_tensor(inputs.data(0).astype(np.int64),
                                    device=dev)
    return ref.dense_rank(M, cell.prime)


def check(cell, inputs, kept: dict, dev, torch, lu: bool):
    """The reference's counts for each kept call, in call order, each
    with the limit 0: rank_gap, echelon_faults, and span_residual (rank)
    or l_faults and lu_residual (lu)."""
    from . import reference as ref
    p, k = cell.prime, CHECK_VECTORS
    ref_rank = reference_rank(cell, inputs, dev, torch)
    verdicts = []
    for i, out in sorted(kept.items()):
        d = inputs.data(i)
        A = (inputs.indptr, inputs.indices, d)
        rng = np.random.default_rng([inputs.seed, 2, i + 1])
        E = ref.Echelon(*out["U"], out["r"], inputs.m, p, dev)
        got = {"rank_gap": abs(out["r"] - ref_rank),
               "echelon_faults": ref.echelon_faults(E, out["qinv"])}
        if not lu:
            Y = torch.as_tensor(rng.integers(0, p, (inputs.n, k)),
                                device=dev)
            got["span_residual"] = (ref.span_residual(E, *A, Y)
                                    if got["echelon_faults"] == 0
                                    else inputs.m * k)
        else:
            X = torch.as_tensor(rng.integers(0, p, (inputs.m, k)),
                                device=dev)
            got["l_faults"] = ref.l_faults(*out["L"], out["p"], inputs.n,
                                           out["r"], p, dev)
            got["lu_residual"] = ref.lu_residual(A, out["L"], out["U"], X, p)
        del E
        verdicts.append({name: int(v) for name, v in got.items()})
    return verdicts
