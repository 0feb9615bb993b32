"""The plain reference's LU check made exact at every odd p <= 2^32 - 5:
NumPy and PyTorch only, nothing of the program.

`reference.lu_residual` forms A X, U X and L (U X) through
`reference.csr_mm`, whose int64 products of two residues in [0, p) are
exact only while (p - 1)^2 < 2^63, that is p below about 3.04e9: at
2^32 - 5 they wrap and a correct factorization would leave a residue.
Here every product goes through `reference_wide.mulmod` (16-bit limbs
of one factor, each partial below 2^49, reduced mod p before it enters
a sum), and one index_add_ adds at most _CHUNK such residues to an entry
below p, so every sum stays below 2^32 * (2^22 + 1) < 2^55 and no
intermediate value reaches 2^63.  `reference.l_faults` forms no
products, so `operations/pluq_wide.py` uses it as it is.  `dense_rank`
eliminates with the same products, for the rank of the tests' small
matrices (a configuration states its rank).
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import mod
from .reference_wide import mulmod

_CHUNK = 1 << 22             # terms of one index_add_ (and of one gather)


def csr_mm(indptr, indices, data, X: torch.Tensor, p: int) -> torch.Tensor:
    """(CSR n x m) @ X (m x k, entries in [0, p)) mod p, entries in
    [0, p), int64: `reference.csr_mm` with exact products."""
    dev = X.device
    n = len(indptr) - 1
    out = torch.zeros((n, X.shape[1]), dtype=torch.int64, device=dev)
    indptr = np.asarray(indptr, np.int64)
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    for s in range(0, nnz, _CHUNK):
        e = min(nnz, s + _CHUNK)
        r = torch.as_tensor(rows[s:e], device=dev)
        c = torch.as_tensor(np.asarray(indices[s:e], np.int64), device=dev)
        v = mod(torch.as_tensor(np.asarray(data[s:e], np.int64), device=dev),
                p)
        out.index_add_(0, r, mulmod(v[:, None], X[c], p))
        out = mod(out, p)
    return out


def lu_residual(A, L, U, X: torch.Tensor, p: int) -> int:
    """Entries where A X != L (U X) mod p (X in [0, p)); A, L, U are
    (indptr, indices, data) triples: `reference.lu_residual` with exact
    products."""
    AX = csr_mm(*A, X, p)
    for (_, idx, _), width in ((U, X.shape[0]), (L, len(U[0]) - 1)):
        if len(idx) and (int(np.max(idx)) >= width or int(np.min(idx)) < 0):
            return AX.numel()               # L and U do not compose
    LUX = csr_mm(*L, csr_mm(*U, X, p), p)
    if AX.shape != LUX.shape:
        return AX.numel()
    return int((AX != LUX).sum())


def dense_rank(M: torch.Tensor, p: int) -> int:
    """Rank of the dense matrix M (any integers) mod p, on M's device, by
    Gaussian elimination column by column with every product through
    `mulmod` (exact at every odd p <= 2^32 - 5; `reference.dense_rank`
    refuses p with 256 (p - 1)^2 >= 2^53).  O(n m min(n, m)): for the
    small matrices of the tests, not for a configuration's."""
    A = mod(M.to(torch.int64), p)
    n, m = A.shape
    r = 0
    for j in range(m):
        if r == n:
            break
        nz = torch.nonzero(A[r:, j])
        if nz.numel() == 0:
            continue
        i = r + int(nz[0, 0])
        if i != r:
            A[[r, i]] = A[[i, r]]
        inv = pow(int(A[r, j]), p - 2, p)
        A[r, j:] = mulmod(A[r, j:], torch.full_like(A[r, j:], inv), p)
        A[r + 1:, j:] = mod(A[r + 1:, j:]
                            - mulmod(A[r + 1:, j:j + 1], A[r:r + 1, j:], p), p)
        r += 1
    return r
