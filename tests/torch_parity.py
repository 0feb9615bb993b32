"""Shared by the port's tests of the factorization's consumers and tools
(tests/test_torch_{solve,kernel,certificate,graph,cli}.py): the moduli and
fixtures, the exact CSR comparison, and the carry of a JAX factorization
into the port (`interop.lu_from_numpy`), so each consumer also runs on the
very factorization the JAX package's consumer gets."""
import numpy as np

from spasm_tpu_torch.interop import lu_from_numpy
from tests.conftest import ALL_MODULI, MATRIX  # noqa: F401

# the JAX package's grid (every digit tier), the tools' default modulus
# and 65269, the top of the d = 2 tier (65279 = 29 * 2251 is not prime)
MODULI = ALL_MODULI + [42013, 65269]

# tests/test_lu_solve.py's fixtures
FAST = ["singular.sms", "small.sms", "upper_trapeze.sms",
        "lower_trapeze.sms", "rectangular_h.sms", "rectangular_l.sms",
        "dm.sms", "G2.sms", "t1.sms", "singular2.sms", "chains2.sms"]


def same_csr(a, b) -> bool:
    return ((a.n, a.m, a.prime) == (b.n, b.m, b.prime)
            and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices[:a.nnz], b.indices[:b.nnz])
            and np.array_equal(a.data[:a.nnz], b.data[:b.nnz]))


def _arrays(M):
    return (M.n, M.m, M.prime, M.indptr, M.indices[:M.nnz], M.data[:M.nnz])


def carried(j):
    """The port's LU around the arrays of a JAX factorization j (L and p
    when j has them)."""
    L = j.L
    return lu_from_numpy(j.r, _arrays(j.U), j.qinv,
                         None if L is None else _arrays(L),
                         None if L is None else j.p, j.complete)
