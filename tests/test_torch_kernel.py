"""Kernel bases and the RREF of an echelonization: the port's `kernel`,
`kernel_from_rref` and `rref` (spasm_tpu_torch/{kernel,rref}.py) against
the JAX package's on the same inputs, tolerance 0, on
tests/test_lu_solve.py's fixtures at every modulus of
tests/torch_parity.py.  Both sides echelonize with default options (no
L); each consumer also runs on the JAX factorization carried into the
port without L (`interop.lu_from_numpy(..., L=None, p=None)`).  The
native and the pure-Python branches of `rref` and `schur.solve_rows`
(under `kernel`) are held to each other."""
import functools

import numpy as np
import pytest
import torch

from spasm_tpu import echelonize as jechelonize
from spasm_tpu import kernel as jkernel
from spasm_tpu import kernel_from_rref as jkernel_from_rref
from spasm_tpu import rref as jrref
from spasm_tpu import sio as jsio
from spasm_tpu.gen import synthetic_sparse as jsynthetic_sparse

from spasm_tpu_torch import (echelonize, kernel, kernel_from_rref, native,
                             rref, sio)
from spasm_tpu_torch.gen import synthetic_sparse
from spasm_tpu_torch.schur import solve_rows
from spasm_tpu_torch.spmv import xApy
from tests.torch_parity import FAST, MATRIX, MODULI, carried, same_csr

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _fact(name, p):
    """(port A, JAX echelon form, port echelon form), default options."""
    J, _ = jsio.load_csr(MATRIX / name, p)
    A, _ = sio.load_csr(MATRIX / name, p)
    return A, jechelonize(J), echelonize(A, device="cpu")


def _annihilates(K, A) -> bool:
    At = A.transpose()
    for i in range(K.n):
        x = np.zeros(K.m, np.int32)
        cols, vals = K.row(i)
        if cols.size == 0:
            return False
        x[cols] = vals
        y = np.zeros(At.m, np.int32)
        xApy(x, At, y)
        if np.any(y):
            return False
    return True


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", FAST)
def test_kernel_matches_jax(name, p):
    """kernel bit-equal to the JAX package's, on the port's and on the
    carried factorization; K.n == m - r and every row annihilates A
    (tests/test_lu_solve.py:test_kernel)."""
    A, j, t = _fact(name, p)
    assert t.r == j.r and same_csr(t.U, j.U)
    want = jkernel(j)
    K = kernel(t)
    assert same_csr(K, want) and same_csr(kernel(carried(j)), want)
    assert K.n == A.m - t.r and _annihilates(K, A)


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", FAST)
def test_rref_matches_jax(name, p):
    """(R, Rqinv) bit-equal to the JAX package's, on the port's and on
    the carried factorization."""
    _, j, t = _fact(name, p)
    Rj, qj = jrref(j)
    for fact in (t, carried(j)):
        R, q = rref(fact)
        assert same_csr(R, Rj) and np.array_equal(q, qj)


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", FAST)
def test_kernel_from_rref_matches_jax(name, p):
    """kernel_from_rref(*rref(fact)) bit-equal to the JAX package's and
    to kernel(fact)."""
    _, j, t = _fact(name, p)
    K = kernel_from_rref(*rref(t))
    assert same_csr(K, jkernel_from_rref(*jrref(j)))
    assert same_csr(K, kernel(t))


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", FAST)
def test_rref_and_kernel_branches_agree(name, p, monkeypatch):
    """rref's batched native solve and its scalar loop, and kernel over
    solve_rows' native and host solvers, give the same results."""
    _, _, t = _fact(name, p)
    assert native.available()
    R1, q1 = rref(t)
    K1 = kernel(t)
    monkeypatch.setattr(native, "available", lambda: False)
    R2, q2 = rref(t)
    assert same_csr(R1, R2) and np.array_equal(q1, q2)
    assert same_csr(K1, kernel(t))


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", FAST)
def test_solve_rows_branches_agree(name, p, monkeypatch):
    """schur.solve_rows: every row of A solved against U, native and on
    the host, the same (cols, vals)."""
    A, _, t = _fact(name, p)
    rows = np.arange(A.n)
    got = solve_rows(t.U, A, rows, t.qinv, p)
    monkeypatch.setattr(native, "available", lambda: False)
    want = solve_rows(t.U, A, rows, t.qinv, p)
    assert len(got) == len(want) == A.n
    for (c1, v1), (c2, v2) in zip(got, want):
        assert np.array_equal(c1, c2) and np.array_equal(v1, v2)


def test_lu_from_numpy_without_L():
    """A JAX factorization without L carried across: L and p stay None,
    and the consumers of U run on it."""
    _, j, _ = _fact("singular.sms", 257)
    assert j.L is None
    fact = carried(j)
    assert fact.L is None and fact.p is None and not fact.complete
    assert fact.r == j.r and same_csr(fact.U, j.U)
    assert np.array_equal(fact.qinv, j.qinv)
    assert same_csr(kernel(fact), jkernel(j))


def test_kernel_from_rref():
    """tests/test_lu_solve.py:test_kernel_from_rref on the port."""
    A, _, t = _fact("singular.sms", 257)
    K = kernel_from_rref(*rref(t))
    assert K.n == A.m - t.r and _annihilates(K, A)


@pytest.mark.parametrize("p", [42013, 4294967291])
def test_kernel_of_a_wide_synthetic_matrix(p):
    """bench.py config 4's rank-deficient shape (2048 x 2560) at an
    eighth of its size, synthetic_sparse(256, 320, 8, p): 64 kernel rows
    at least, bit-equal to the JAX package's, kernel_from_rref(*rref)
    the same basis."""
    J, A = jsynthetic_sparse(256, 320, 8, p), synthetic_sparse(256, 320, 8, p)
    j, t = jechelonize(J), echelonize(A, device="cpu")
    K = kernel(t)
    assert K.n == A.m - t.r >= 64
    assert same_csr(K, jkernel(j)) and _annihilates(K, A)
    assert same_csr(K, kernel_from_rref(*rref(t)))
