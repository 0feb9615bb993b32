"""Bridges from the JAX package's state, as numpy arrays, to the port's.

  * `csr_from_numpy(n, m, prime, indptr, indices, data)`: a port CSR
    from the arrays of a `spasm_tpu.csr.CSR`;
  * `ReducedBasis.from_numpy(R, qfree, pivcols, m, prime, device)`
    (dense/reduced.py): a port reduced basis around an R built by the
    JAX package, so `form_block` can be compared on its own;
  * `lu_from_numpy(r, U, qinv, L=None, p=None, complete=False)`: a port
    LU around the factors of a JAX factorization (L and p None for one
    without L), so the port's certificate checks and consumers (rref,
    kernel, solve) can be run on it.

Neither imports JAX: the caller passes numpy arrays.
"""
from __future__ import annotations

import numpy as np

from .csr import CSR
from .dense.reduced import ReducedBasis
from .echelonize import LU
from .field import Field

__all__ = ["csr_from_numpy", "lu_from_numpy", "ReducedBasis"]


def csr_from_numpy(n: int, m: int, prime: int, indptr, indices,
                   data) -> CSR:
    return CSR(n, m, Field(prime), np.asarray(indptr, np.int64),
               np.asarray(indices, np.int32), np.asarray(data, np.int32))


def lu_from_numpy(r: int, U, qinv, L=None, p=None,
                  complete: bool = False) -> LU:
    """U and L: (n, m, prime, indptr, indices, data) tuples, the arrays of
    a `spasm_tpu.csr.CSR`; qinv (m,) and p (r,) as numpy arrays.  L and p
    are None for a factorization without L."""
    return LU(r, csr_from_numpy(*U), np.asarray(qinv, np.int64),
              L=None if L is None else csr_from_numpy(*L),
              p=None if p is None else np.asarray(p, np.int64),
              complete=complete)
