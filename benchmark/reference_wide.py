"""The plain reference's span check made exact at every odd p <= 2^32 - 5:
NumPy and PyTorch only, nothing of the program.

`reference.span_residual` multiplies two residues in [0, p) in int64,
which is exact only while (p - 1)^2 < 2^63, that is p below about
3.04e9: at 2^32 - 5 the products wrap and a correct answer would leave
a residue.  Here every product is formed from 16-bit limbs of one factor
and reduced mod p before it enters a sum (`mulmod`: each partial below
2^49), and every sum holds at most _CHUNK terms below p (below 2^55), so
no intermediate value reaches 2^63.  A level's coefficients are read
before any of its chunks is applied, as `reference.span_residual`
reads them.  `reference.Echelon` and
`reference.echelon_faults` form no products, so they are used as they
are.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import Echelon, mod

_CHUNK = 1 << 22             # terms of one index_add_ (and of one gather)


def mulmod(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(a * b) mod p, exact, for int64 a and b in [0, p), p < 2^32
    (broadcasting as `*` does): b = hi * 2^16 + lo, and a * hi mod p,
    times 2^16, plus a * lo, each below 2^49."""
    hi = torch.bitwise_right_shift(b, 16)
    lo = torch.bitwise_and(b, 0xFFFF)
    return mod(mod(a * hi, p) * 65536 + a * lo, p)


def span_residual(E: Echelon, A_indptr, A_indices, A_data, Y: torch.Tensor
                  ) -> int:
    """Nonzeros of Y^T A (k random rows of rowspan(A), Y in [0, p))
    left after reduction by U in topological order (`echelon_faults`
    first, which sets E's levels); `reference.span_residual` with exact
    products."""
    p, dev = E.p, E.dev
    n = len(A_indptr) - 1
    X = torch.zeros((E.m, Y.shape[1]), dtype=torch.int64, device=dev)
    # X^T = Y^T A, formed as A^T Y by scattering rows of A
    rows = torch.as_tensor(np.repeat(np.arange(n, dtype=np.int64),
                                     np.diff(np.asarray(A_indptr, np.int64))),
                           device=dev)
    cols = torch.as_tensor(np.asarray(A_indices, np.int64), device=dev)
    vals = mod(torch.as_tensor(np.asarray(A_data, np.int64), device=dev), p)
    for s in range(0, cols.numel(), _CHUNK):
        e = s + _CHUNK
        X.index_add_(0, cols[s:e], mulmod(vals[s:e, None], Y[rows[s:e]], p))
        X = mod(X, p)
    if E.r == 0:
        return int((X != 0).sum())
    lev = E.level[E.rows]
    order = torch.argsort(lev, stable=True)
    rows_o, cols_o, vals_o = E.rows[order], E.cols[order], E.vals[order]
    nlev = int(E.level.max()) + 1
    bounds = torch.searchsorted(lev[order], torch.arange(
        nlev + 1, device=dev)).tolist()
    for t in range(nlev):
        s0, e0 = bounds[t], bounds[t + 1]
        if s0 == e0:
            continue
        c = X[E.piv[rows_o[s0:e0]]]          # (entries, k): row's coef
        for s in range(s0, e0, _CHUNK):
            e = min(s + _CHUNK, e0)
            X.index_add_(0, cols_o[s:e],
                         -mulmod(vals_o[s:e, None], c[s - s0:e - s0], p))
            X = mod(X, p)
    return int((X != 0).sum())
