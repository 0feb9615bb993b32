"""Linear-system solving through a complete PLUQ factorization.

Vendored from spasm_tpu/solve.py, a port of SpaSM src/spasm_solve.c:
x.A = b is solved as a forward solve z.U = b (consistency check)
followed by a back solve x.L = z.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .csr import CSR
from .echelonize import LU
from .spmv import scatter
from .triangular import dense_back_solve, dense_forward_solve


def solve(fact: LU, b: np.ndarray) -> Tuple[bool, np.ndarray]:
    """Solve x.A = b (b of size m).  Returns (ok, x of size n).
    (spasm_solve.c:13-47)"""
    L, U = fact.L, fact.U
    assert L is not None, "solve requires a factorization with L (opts.L)"
    m = U.m
    r = U.n
    qinv = fact.qinv
    # Uq[i] = pivot column of row i
    Uq = np.empty(r, dtype=np.int64)
    cols = np.nonzero(np.asarray(qinv) >= 0)[0]
    Uq[np.asarray(qinv)[cols]] = cols
    y = b.astype(np.int64).copy()
    ok, z = dense_forward_solve(U, y, Uq)
    x = dense_back_solve(L, z.astype(np.int64), fact.p)
    return ok, x


def gesv(fact: LU, B: CSR, want_ok: bool = True):
    """Solve X.A == B for every row of B (spasm_solve.c:52-93).

    Returns (X: CSR, ok: bool array or None); row i of X is garbage when
    ok[i] is False.

    Batched: ONE parallel native triangular-solve call per phase — all
    forward solves z.U = b together, then all back solves x.L = z
    together against a unit-diagonal row-scaling of L (the reference
    parallelizes the same two phases per-row under OpenMP,
    spasm_solve.c:65-81).
    """
    from . import native
    if not native.available() or B.n == 0 or fact.U.n == 0:
        return _gesv_serial(fact, B, want_ok)
    L, U = fact.L, fact.U
    n = B.n
    r = U.n
    prime = B.prime
    F = U.field
    qinv = np.asarray(fact.qinv, np.int64)
    rows = np.arange(n, dtype=np.int64)

    # phase 1: forward solves z.U = b, all rows in one parallel call;
    # the parked coefficient at pivot column c is z[qinv[c]], and any
    # residue on a non-pivotal column means b is outside rowspace(U)
    fw = native.solve_batch(U, B, rows, qinv, prime)
    ok = np.ones(n, dtype=bool) if want_ok else None
    zrows = []
    for i, (cols, vals) in enumerate(fw):
        piv = qinv[cols] >= 0
        if ok is not None and not piv.all():
            ok[i] = not np.any(vals[~piv])
        zc = qinv[cols[piv]]
        order = np.argsort(zc)
        zrows.append((zc[order].astype(np.int32),
                      vals[piv][order].astype(np.int32)))
    Z = CSR.from_rows(n, max(r, 1), prime, zrows)

    # phase 2: back solves x.L = z.  Scale pivot row p[j] of L by the
    # inverse of its diagonal entry so the pivots are unitary, run one
    # batched triangular solve, then unscale the solution entries.
    p = np.asarray(fact.p[:r], np.int64)
    Ls = L.copy()
    from .csr import _concat_ranges
    starts = Ls.indptr[p]
    lens = (Ls.indptr[p + 1] - starts).astype(np.int64)
    gather = _concat_ranges(starts, lens)
    rowrep = np.repeat(np.arange(r), lens)
    on_diag = Ls.indices[gather] == rowrep
    diag = np.zeros(r, np.int64)
    diag[rowrep[on_diag]] = Ls.data[gather[on_diag]]
    dinv = F.inverse_array(diag).astype(np.int64)
    Ls.data[gather] = F.narray(
        Ls.data[gather].astype(np.int64) * dinv[rowrep]).astype(np.int32)
    qinv_L = p.copy()                      # pivot of column j at row p[j]
    bw = native.solve_batch(Ls, Z, rows, qinv_L, prime)
    xrows = []
    for i, (cols, vals) in enumerate(bw):
        # every column of L is pivotal; the coefficient at column j
        # belongs to solution entry p[j], unscaled by dinv
        xr = p[cols]
        xv = F.narray(vals.astype(np.int64) * dinv[cols])
        order = np.argsort(xr)
        keep = xv[order] != 0
        xrows.append((xr[order][keep].astype(np.int32),
                      xv[order][keep].astype(np.int32)))
    X = CSR.from_rows(n, L.n, prime, xrows)
    return X, ok


def _gesv_serial(fact: LU, B: CSR, want_ok: bool = True):
    """Per-row scalar fallback (no native library)."""
    n, m = B.n, B.m
    Xm = fact.L.n
    ok = np.zeros(n, dtype=bool) if want_ok else None
    rows = []
    for i in range(n):
        b = np.zeros(m, dtype=np.int64)
        scatter(B, i, 1, b)
        res, x = solve(fact, b)
        if ok is not None:
            ok[i] = res
        nz = np.nonzero(x)[0]
        rows.append((nz.astype(np.int32), x[nz].astype(np.int32)))
    X = CSR.from_rows(n, Xm, B.prime, rows)
    return X, ok
