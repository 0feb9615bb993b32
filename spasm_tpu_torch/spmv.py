"""Sparse matrix-vector products and row scatter over GF(p), host side.
Vendored from spasm_tpu/spmv.py.

Vectorized numpy equivalents of SpaSM src/spasm_scatter.c and
spasm_spmv.c.  Each product term is reduced mod p before accumulation so
int64 accumulators cannot overflow for any p <= 2^32 - 5.
"""
from __future__ import annotations

import numpy as np

from .csr import CSR


def scatter(A: CSR, i: int, beta: int, x: np.ndarray):
    """x += beta * A[i] (dense accumulator x, balanced int32/int64).

    The innermost kernel of the reference (spasm_scatter.c:7-16).
    """
    cols, vals = A.row(i)
    if cols.size == 0 or beta == 0:
        return
    F = A.field
    x[cols] = F.narray(np.int64(beta) * vals.astype(np.int64)
                       + x[cols].astype(np.int64))


def xApy(x: np.ndarray, A: CSR, y: np.ndarray) -> np.ndarray:
    """y += x * A (row-vector times matrix; spasm_spmv.c:10-21)."""
    F = A.field
    rows = A.row_ids()
    vals = A.data[:A.nnz]
    t = F.narray(x[rows].astype(np.int64) * vals.astype(np.int64))
    acc = y.astype(np.int64)
    np.add.at(acc, A.indices[:A.nnz], t.astype(np.int64))
    y[:] = F.narray(acc)
    return y


def Axpy(A: CSR, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """y += A * x (matrix times column-vector; spasm_spmv.c:27-38)."""
    F = A.field
    rows = A.row_ids()
    vals = A.data[:A.nnz]
    t = F.narray(vals.astype(np.int64)
                 * x[A.indices[:A.nnz]].astype(np.int64))
    acc = y.astype(np.int64)
    np.add.at(acc, rows, t.astype(np.int64))
    y[:] = F.narray(acc)
    return y
