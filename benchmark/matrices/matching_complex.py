"""Boundary maps of matching complexes (the mk<n>.b<j> family of Dumas's
Sparse Integer Matrix Collection): b<j> of M_n has a row for each
(j+1)-edge matching of K_n, a column for each j-edge matching, and the
entry (-1)^t at the column that deletes the t-th edge (edge (u, v),
u < v, has id u*n + v; edges ascending within a matching; rows and
columns in lexicographic order).

A frozen, vectorised copy of the construction in the program's own
generator (`spasm_tpu_torch.gen.matching_complex_boundary`): the same
matrix, entry for entry, kept here so the benchmark's input cannot move
with the program.  `generate(n, j, transpose)` returns
(rows, cols, indptr int64, indices int32, values int64); `transpose`
gives the orientation the rank tool uses when a matrix has fewer rows
than columns (mk13.b5: 270270 x 135135).
"""
from __future__ import annotations

import numpy as np


def matchings(n: int, k: int) -> np.ndarray:
    """All k-edge matchings of K_n, (count, k) int64 edge ids, each row
    ascending, rows in lexicographic order."""
    us, vs = np.triu_indices(n, 1)
    eid = (us * n + vs).astype(np.int64)
    ebits = (np.int64(1) << us) | (np.int64(1) << vs)
    cur = eid[:, None]
    used = ebits.copy()
    last = np.arange(eid.size)
    for _ in range(k - 1):
        ok = ((np.arange(eid.size)[None, :] > last[:, None])
              & ((used[:, None] & ebits[None, :]) == 0))
        par, ext = np.nonzero(ok)         # row-major: lexicographic order
        cur = np.concatenate([cur[par], eid[ext][:, None]], axis=1)
        used = used[par] | ebits[ext]
        last = ext
    return cur if k else np.zeros((1, 0), np.int64)


def _keys(m: np.ndarray) -> np.ndarray:
    """Order-preserving int64 key of each ascending row of edge ids."""
    key = np.zeros(m.shape[0], np.int64)
    for t in range(m.shape[1]):
        key = key * 256 + m[:, t]
    return key


def generate(n: int, j: int, transpose: bool = False):
    if n * n > 256 or j + 1 > 7:
        raise ValueError("edge ids need n * n <= 256 and j + 1 <= 7")
    rows_m = matchings(n, j + 1)
    col_keys = _keys(matchings(n, j))
    R = rows_m.shape[0]
    indices = np.empty((R, j + 1), np.int64)
    values = np.empty((R, j + 1), np.int64)
    for t in range(j + 1):
        face = np.delete(rows_m, t, axis=1)
        indices[:, t] = np.searchsorted(col_keys, _keys(face))
        values[:, t] = 1 if t % 2 == 0 else -1
    indptr = np.arange(R + 1, dtype=np.int64) * (j + 1)
    shape = (R, col_keys.size)
    if not transpose:
        return shape[0], shape[1], indptr, indices.ravel().astype(np.int32), \
            values.ravel()
    # CSR of the transpose: entries sorted by (column, row)
    r = np.repeat(np.arange(R, dtype=np.int64), j + 1)
    c = indices.ravel()
    order = np.lexsort((r, c))
    tptr = np.zeros(shape[1] + 1, np.int64)
    np.cumsum(np.bincount(c, minlength=shape[1]), out=tptr[1:])
    return (shape[1], shape[0], tptr, r[order].astype(np.int32),
            values.ravel()[order])
