"""Linear systems through a complete PLUQ: the port's `solve` and `gesv`
(spasm_tpu_torch/solve.py) against the JAX package's on the same inputs,
tolerance 0, on tests/test_lu_solve.py's fixtures at every modulus of
tests/torch_parity.py.  Both sides factor; each consumer also runs on the
JAX factorization carried into the port, so a consumer's fault cannot
hide behind an echelonize difference.  The native and the pure-Python
branch of `gesv` are held to each other."""
import functools

import numpy as np
import pytest
import torch

from spasm_tpu import EchelonizeOptions as JOpts
from spasm_tpu import echelonize as jechelonize
from spasm_tpu import gesv as jgesv
from spasm_tpu import sio as jsio
from spasm_tpu import solve as jsolve
from spasm_tpu.csr import CSR as JCSR

from spasm_tpu_torch import (CSR, EchelonizeOptions, echelonize, gesv,
                             native, sio, solve)
from spasm_tpu_torch.field import Field
from spasm_tpu_torch.spmv import xApy
from tests.torch_parity import FAST, MATRIX, MODULI, carried, same_csr

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _pluq(name, p):
    """(port A, JAX complete PLUQ, port complete PLUQ)."""
    J, _ = jsio.load_csr(MATRIX / name, p)
    A, _ = sio.load_csr(MATRIX / name, p)
    j = jechelonize(J, JOpts(complete=True))
    t = echelonize(A, EchelonizeOptions(complete=True), device="cpu")
    return A, j, t


def _rhs(A, p, seed):
    """Rows B = X.A for 4 random X, then 2 random rows (outside the row
    space of a rank-deficient A)."""
    rng = np.random.default_rng(seed)
    F = Field(p)
    rows = []
    for x in rng.integers(0, p, (4, A.n)):
        b = np.zeros(A.m, np.int32)
        xApy(F.narray(x).astype(np.int32), A, b)
        rows.append((np.nonzero(b)[0].astype(np.int32), b[b != 0]))
    for b in F.narray(rng.integers(0, p, (2, A.m))).astype(np.int32):
        rows.append((np.nonzero(b)[0].astype(np.int32), b[b != 0]))
    return rows


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", FAST)
def test_complete_pluq_feeds_both_sides(name, p):
    _, j, t = _pluq(name, p)
    assert t.r == j.r and np.array_equal(t.qinv, j.qinv)
    assert np.array_equal(t.p, j.p) and t.complete == j.complete
    assert same_csr(t.U, j.U) and same_csr(t.L, j.L)


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", FAST)
def test_solve_matches_jax(name, p):
    """A forged b = x.A (tests/test_lu_solve.py:test_solve_forged_rhs):
    ok, and y.A == b; and a random b.  (ok, y) bit-equal to the JAX
    package's, on the port's and on the carried factorization."""
    A, j, t = _pluq(name, p)
    F = Field(p)
    rng = np.random.default_rng(5)
    b = np.zeros(A.m, dtype=np.int32)
    xApy(F.narray(rng.integers(0, p, A.n)), A, b)
    for rhs, forged in ((b, True),
                        (F.narray(rng.integers(0, p, A.m)), False)):
        want_ok, want_y = jsolve(j, rhs.astype(np.int64))
        for fact in (t, carried(j)):
            ok, y = solve(fact, rhs.astype(np.int64))
            assert ok == want_ok and np.array_equal(y, want_y)
        if forged:
            assert ok
            b2 = np.zeros(A.m, dtype=np.int32)
            xApy(y.astype(np.int32), A, b2)
            assert np.array_equal(b2, b)


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", FAST)
def test_gesv_matches_jax(name, p):
    """(X, ok) bit-equal to the JAX package's on B = A's rows, X.A rows
    and random rows; with want_ok=False too."""
    A, j, t = _pluq(name, p)
    rows = [A.row(i) for i in range(A.n)] + _rhs(A, p, 3)
    B = CSR.from_rows(len(rows), A.m, p, rows)
    Xj, okj = jgesv(j, JCSR.from_rows(len(rows), A.m, p, rows))
    for fact in (t, carried(j)):
        X, ok = gesv(fact, B)
        assert same_csr(X, Xj) and np.array_equal(ok, okj)
    X, ok = gesv(t, B, want_ok=False)
    assert ok is None and same_csr(X, Xj)
    assert okj[:A.n + 4].all()


@pytest.mark.parametrize("p", MODULI)
@pytest.mark.parametrize("name", FAST)
def test_gesv_native_and_python_branches_agree(name, p, monkeypatch):
    """The batched native gesv and the per-row `_gesv_serial` give the
    same X and ok (the garbage rows of a refused b included)."""
    A, _, t = _pluq(name, p)
    rows = _rhs(A, p, 9)
    B = CSR.from_rows(len(rows), A.m, p, rows)
    assert native.available()
    X1, ok1 = gesv(t, B)
    monkeypatch.setattr(native, "available", lambda: False)
    X2, ok2 = gesv(t, B)
    assert same_csr(X1, X2) and np.array_equal(ok1, ok2)


def test_solve_rejects_bogus_rhs():
    """tests/test_lu_solve.py:test_solve_rejects_bogus_rhs on the port."""
    p = 257
    A, _, t = _pluq("singular.sms", p)
    assert t.r < A.m
    rng = np.random.default_rng(7)
    found_reject = False
    for _ in range(10):
        b = Field(p).narray(rng.integers(1, p, A.m)).astype(np.int64)
        ok, _ = solve(t, b)
        if not ok:
            found_reject = True
            break
    assert found_reject


@pytest.mark.parametrize("name", ["singular.sms", "small.sms", "dm.sms"])
def test_gesv(name):
    """tests/test_lu_solve.py:test_gesv on the port: X.A == A."""
    A, _, t = _pluq(name, 257)
    X, ok = gesv(t, A)
    assert ok is not None and np.all(ok)
    for i in range(A.n):
        xi = np.zeros(X.m, np.int32)
        cols, vals = X.row(i)
        xi[cols] = vals
        b = np.zeros(A.m, np.int32)
        xApy(xi, A, b)
        want = np.zeros(A.m, np.int32)
        ac, av = A.row(i)
        want[ac] = av
        assert np.array_equal(b, want)
