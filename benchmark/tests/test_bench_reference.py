"""The plain reference on tiny inputs: it passes true answers and
counts each kind of wrong one."""
import numpy as np
import pytest
import torch

from benchmark import reference as ref

P = 42013
CPU = torch.device("cpu")


def brute_rank(A, p=P):
    A = np.array(A, dtype=object) % p
    n, m = A.shape
    r = 0
    for j in range(m):
        piv = [i for i in range(r, n) if A[i, j] % p]
        if not piv:
            continue
        A[[r, piv[0]]] = A[[piv[0], r]]
        A[r] = A[r] * pow(int(A[r, j]), p - 2, p) % p
        for i in range(n):
            if i != r and A[i, j]:
                A[i] = (A[i] - A[i, j] * A[r]) % p
        r += 1
    return r


def csr(D):
    D = np.asarray(D, np.int64)
    rows, cols = np.nonzero(D)
    indptr = np.zeros(D.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=D.shape[0]), out=indptr[1:])
    return indptr, cols.astype(np.int32), D[rows, cols]


@pytest.mark.parametrize("shape,k", [((40, 30), 30), ((30, 50), 12),
                                     ((70, 70), 52), ((9, 300), 9)])
@pytest.mark.parametrize("block", [4, 256])
def test_dense_rank(shape, k, block):
    rng = np.random.default_rng(shape[0] * 7 + k)
    n, m = shape
    A = rng.integers(0, P, (n, k)) @ rng.integers(0, 4, (k, m)) % P
    A[:, 1] = 0
    assert ref.dense_rank(torch.tensor(A), P, block) == brute_rank(A)


def echelon():
    """A (4 x 6) echelon basis, rows out of pivot order, and its qinv."""
    U = np.array([[0, 0, 1, 5, 0, 7],
                  [1, 3, 0, 2, 0, 1],
                  [0, 0, 0, 1, 0, 4],
                  [0, 0, 0, 0, 1, 9]])
    qinv = np.array([1, -1, 0, 2, 3, -1])
    return U, qinv


def check(U, qinv, r=None):
    E = ref.Echelon(*csr(U), U.shape[0] if r is None else r, U.shape[1], P,
                    CPU)
    return E, ref.echelon_faults(E, qinv)


def test_echelon_accepts_a_basis():
    U, qinv = echelon()
    assert check(U, qinv)[1] == 0


@pytest.mark.parametrize("break_it", ["unit", "qinv", "cycle", "rank"])
def test_echelon_counts_faults(break_it):
    U, qinv = echelon()
    r = None
    if break_it == "unit":
        U[2, 3] = 2
    elif break_it == "qinv":
        qinv[5] = 3
    elif break_it == "cycle":            # row 2 feeds row 0 and back
        U[2, 2] = 3
    else:
        r = 3
    assert check(U, qinv, r)[1] > 0


def test_span_residual_finds_a_row_outside():
    U, qinv = echelon()
    rng = np.random.default_rng(0)
    inside = rng.integers(0, P, (5, 4)) @ U % P
    Y = torch.as_tensor(rng.integers(0, P, (6, 2)))
    E, faults = check(U, qinv)
    assert faults == 0
    assert ref.span_residual(E, *csr(inside), Y[:5]) == 0
    outside = np.vstack([inside, [0, 1, 0, 0, 0, 0]])
    assert ref.span_residual(E, *csr(outside), Y) > 0


def lu():
    L = np.array([[2, 0, 0], [1, 0, 3], [0, 5, 0], [4, 1, 1]])
    U = np.array([[1, 2, 0, 3], [0, 0, 1, 1], [0, 1, 0, 6]])
    return L, U, np.array([0, 2, 1])


def test_lu_residual_and_l_faults():
    L, U, p = lu()
    A = L @ U % P
    X = torch.as_tensor(np.random.default_rng(1).integers(0, P, (4, 2)))
    assert ref.lu_residual(csr(A), csr(L), csr(U), X, P) == 0
    assert ref.l_faults(*csr(L), p, 4, 3, P, CPU) == 0
    L2 = L.copy()
    L2[3, 0] += 1
    assert ref.lu_residual(csr(A), csr(L2), csr(U), X, P) > 0
    L3 = L.copy()
    L3[2, 1] = 0                           # a zero on L[p, :]'s diagonal
    assert ref.l_faults(*csr(L3), p, 4, 3, P, CPU) > 0
    assert ref.l_faults(*csr(L), np.array([0, 2, 2]), 4, 3, P, CPU) > 0
    # U one row short: L and U do not compose
    assert ref.lu_residual(csr(A), csr(L), csr(U[:2]), X, P) > 0
