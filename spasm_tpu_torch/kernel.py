"""Right-kernel basis from an echelonization.

Vendored from spasm_tpu/kernel.py, a port of SpaSM src/spasm_kernel.c:
for every non-pivotal column j, solve a sparse triangular system against
U^T; the kernel row is [-1 at column j; solution coefficients at the
pivot columns].
Rows are committed in column order (deterministic).
"""
from __future__ import annotations

import numpy as np

from .csr import CSR
from .echelonize import LU
from .triangular import sparse_triangular_solve


def kernel(fact: LU) -> CSR:
    """Basis of the right kernel of A (rows k satisfy k . A^T = 0 when A
    is viewed through its echelon form U).  (spasm_kernel.c:9-127)"""
    U = fact.U
    qinv = np.asarray(fact.qinv, np.int64)
    n, m = U.n, U.m
    assert n <= m
    Ut = U.transpose()
    # locate pivots in Ut: row j of Ut holds the pivot of U row i at (j, i)
    # Utqinv[col i of Ut] = row j of Ut containing that pivot
    Utqinv = np.full(n, -1, dtype=np.int64)
    cols_piv = np.nonzero(qinv >= 0)[0]
    Utqinv[qinv[cols_piv]] = cols_piv
    free_cols = np.nonzero(qinv < 0)[0]
    from .schur import solve_rows
    solved = solve_rows(Ut, Ut, free_cols, Utqinv, U.prime)
    rows = []
    for j, (cols, vals) in zip(free_cols, solved):
        keep = Utqinv[cols] >= 0
        kcols = np.concatenate(([j], Utqinv[cols[keep]]))
        kvals = np.concatenate(([-1], vals[keep]))
        order = np.argsort(kcols)
        rows.append((kcols[order].astype(np.int32),
                     kvals[order].astype(np.int32)))
    return CSR.from_rows(m - n, m, U.prime, rows)


def kernel_from_rref(R: CSR, qinv: np.ndarray) -> CSR:
    """Kernel basis straight from an RREF — cheaper than from U
    (spasm_kernel.c:133-179)."""
    n, m = R.n, R.m
    assert n <= m
    prime = R.prime
    Rt = R.transpose()
    # p[i] = pivot column of R row i (first entry)
    p = np.asarray([int(R.row(i)[0][0]) for i in range(n)], dtype=np.int64) \
        if n else np.empty(0, np.int64)
    rows = []
    for j in range(m):
        if qinv[j] >= 0:
            continue
        tcols, tvals = Rt.row(j)
        cols = np.concatenate(([j], p[tcols]))
        vals = np.concatenate(([prime - 1], tvals)).astype(np.int64)
        order = np.argsort(cols)
        F = R.field
        rows.append((cols[order].astype(np.int32),
                     F.narray(vals[order]).astype(np.int32)))
    return CSR.from_rows(m - n, m, prime, rows)
