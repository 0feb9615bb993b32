"""RREF of an echelonized matrix.

Vendored from spasm_tpu/rref.py (SpaSM src/spasm_rref.c); the native
branch runs when `native.available()`.

!!! Like the reference, this computes the RREF of A*Q (columns permuted so
pivots come first), NOT of A itself (spasm_rref.c:7-21).

Each row of U is re-eliminated against every *other* pivot (its own pivot
is masked during the solve, cf. the reference's per-thread qinv_local,
spasm_rref.c:51-59).  All rows are solved in ONE batched parallel call
(the reference's `omp parallel for`, spasm_rref.c:44) and committed in
row order — deterministic, unlike the reference's first-come parallel
commit (spasm_rref.c:81-118).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .csr import CSR
from .echelonize import LU
from .triangular import sparse_triangular_solve


def rref(fact: LU) -> Tuple[CSR, np.ndarray]:
    """Returns (R, Rqinv).  R's rows are fully reduced; Rqinv locates the
    pivots of R (column j -> row Rqinv[j], or -1)."""
    U = fact.U
    qinv = np.asarray(fact.qinv, np.int64)
    n, m = U.n, U.m
    pivots = np.asarray([int(U.row(i)[0][0]) for i in range(n)], np.int64)
    rows = []
    from . import native
    if native.available() and n:
        solved = native.solve_batch(U, U, np.arange(n, dtype=np.int64),
                                    qinv, U.prime, mask_cols=pivots)
        for i, (cols, vals) in enumerate(solved):
            pivot = int(pivots[i])
            keep = (qinv[cols] < 0) | (cols == pivot)
            live = cols[keep].astype(np.int64)
            x = np.zeros(m, dtype=np.int64)
            x[live] = vals[keep]
            live = np.concatenate(([pivot],
                                   np.sort(live[live != pivot])))
            rows.append((live.astype(np.int32), x[live].astype(np.int32)))
    else:
        x = np.zeros(m, dtype=np.int64)
        qinv_local = qinv.copy()
        for i in range(n):
            pivot = int(pivots[i])
            assert qinv_local[pivot] == i
            qinv_local[pivot] = -1    # mask own pivot during the solve
            pattern, x = sparse_triangular_solve(U, U, i, qinv_local, x)
            live = pattern[(qinv_local[pattern] < 0) & (x[pattern] != 0)]
            live = np.concatenate(([pivot],
                                   np.sort(live[live != pivot])))
            rows.append((live.astype(np.int32), x[live].astype(np.int32)))
            qinv_local[pivot] = i
    R = CSR.from_rows(n, m, U.prime, rows)
    Rqinv = np.full(m, -1, dtype=np.int64)
    for i in range(n):
        cols_i, _ = R.row(i)
        Rqinv[cols_i[0]] = i
    return R, Rqinv
