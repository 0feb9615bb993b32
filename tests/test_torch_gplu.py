"""The GPLU finisher: the port's native `gplu` binding against the JAX
package's on the same inputs, the port's Python finisher against its
native one, and `echelonize` with `enable_dense=False` (every remainder
goes to GPLU) against the JAX package.  Tolerance 0: U, qinv, L and p
are exact."""
import sys

import numpy as np
import pytest
import torch

from spasm_tpu import EchelonizeOptions as JOpts
from spasm_tpu import echelonize as jechelonize
from spasm_tpu import native as jnative
from spasm_tpu import sio as jsio
from spasm_tpu.csr import CSR as JCSR
from spasm_tpu.field import Field as JField

from spasm_tpu_torch import CSR, EchelonizeOptions, echelonize, native, sio
from spasm_tpu_torch.echelonize import _Engine, _GrowingCSR
from spasm_tpu_torch.gen import matching_complex_boundary as mcb
from spasm_tpu_torch.schur import schur_sparse
from tests.conftest import ALL_TEST_MATRICES, MATRIX

torch.set_num_threads(2)
TENG = sys.modules["spasm_tpu_torch.echelonize"]
P = 42013


def _same_csr(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    assert np.array_equal(a.indptr[:a.n + 1], b.indptr[:b.n + 1])
    assert np.array_equal(a.indices[:a.nnz], b.indices[:b.nnz])
    assert np.array_equal(a.data[:a.nnz], b.data[:b.nnz])


def _same_factor(j, t, with_L=False):
    assert t.r == j.r
    assert np.array_equal(t.qinv, j.qinv)
    _same_csr(j.U, t.U)
    if with_L:
        assert np.array_equal(t.p, j.p) and t.complete == j.complete
        _same_csr(j.L, t.L)


def _mk10_round1():
    """mk10.b3 (rank-tool side) after round 0: the Schur complement S of
    the non-pivotal rows, the basis U and its qinv."""
    A = mcb(10, 3)
    if A.n < A.m:
        A = A.transpose()
    eng = _Engine(A, EchelonizeOptions(), "cpu")
    npiv, p = eng.extract_structural(A)
    U = eng.U.snapshot_csr()
    S, p_out = schur_sparse(A, p[npiv:], A.n - npiv,
                            TENG.LU(U.n, U, eng.U.qinv), None, None,
                            use_device=False)
    return S, p_out, U, eng.U.qinv


def _gplu_inputs(case):
    if case == "mk10.b3 round 1":
        S, p_out, U, qinv = _mk10_round1()
        return S, np.arange(S.n)[::-1].copy(), p_out, U, qinv
    S, _ = sio.load_csr(MATRIX / case, P)
    U = CSR.empty(0, S.m, P)
    return S, np.arange(S.n), None, U, np.full(S.m, -1, np.int64)


def _as_jax(A):
    return JCSR(A.n, A.m, JField(A.prime), A.indptr.copy(),
                A.indices.copy(), A.data.copy())


@pytest.mark.parametrize("want_L", [False, True])
@pytest.mark.parametrize("max_piv", [1, 7, 10 ** 9])
@pytest.mark.parametrize("case", ["mk10.b3 round 1", "mat364.sms",
                                  "BIOMD0000000424.int.mpl.sms",
                                  "singular3.sms"])
def test_native_gplu_matches_jax(case, max_piv, want_L):
    assert native.available() and jnative.HAVE_NATIVE
    S, rows, origin, U, qinv = _gplu_inputs(case)
    tq, jq = qinv.copy(), qinv.copy()
    got = native.gplu(S, rows, origin, U, tq, P, want_L, max_piv)
    want = jnative.gplu(_as_jax(S), rows, origin, _as_jax(U), jq, P,
                        want_L, max_piv)
    assert got[0] == want[0] == len(got[1])
    assert 0 < got[0] <= max_piv
    assert np.array_equal(tq, jq)
    assert len(got[1]) == len(want[1])
    for (gc, gv), (wc, wv) in zip(got[1], want[1]):
        assert np.array_equal(gc, wc) and np.array_equal(gv, wv)
        assert gv[0] == 1 and tq[gc[0]] >= 0
    for g, w in zip(got[2], want[2]):
        assert np.array_equal(g, w)
    assert (got[2][0].size > 0) == want_L
    assert np.array_equal(got[3], want[3])


def test_native_gplu_rejects_a_copied_qinv():
    S, rows, origin, U, qinv = _gplu_inputs("mat364.sms")
    with pytest.raises(TypeError):
        native.gplu(S, rows, origin, U, qinv.astype(np.int32), P, False, 5)


def test_growing_csr_appends():
    S, _ = sio.load_csr(MATRIX / "mat364.sms", P)
    G = _GrowingCSR(CSR.empty(0, S.m, P))
    for i in range(S.n):
        c, v = S.row(i)
        G.append_row(c, v)
    assert G.n == S.n
    assert np.array_equal(G.indptr, S.indptr[:S.n + 1])
    assert np.array_equal(G.indices, S.indices[:S.nnz])
    assert np.array_equal(G.data, S.data[:S.nnz])


def _python_finisher(monkeypatch):
    """Send finish_gplu to the Python twin of the native finisher."""
    monkeypatch.setattr(TENG._Engine, "_finish_gplu_native",
                        TENG._Engine._finish_gplu_py)


@pytest.mark.parametrize("name,opts", [
    ("mk10.b3", dict(device_dense_width=0)),      # round 1, then GPLU
    ("mk10.b3", dict(complete=True)),
    ("mat364.sms", dict(enable_dense=False)),
    ("mat364.sms", dict(enable_dense=False, L=True)),
    ("medium.sms", dict(enable_dense=False)),
    ("trefethen_500.sms", dict(enable_dense=False, complete=True))])
def test_python_finisher_matches_native(name, opts, monkeypatch):
    if name == "mk10.b3":
        A = mcb(10, 3)
        A = A.transpose() if A.n < A.m else A
    else:
        A, _ = sio.load_csr(MATRIX / name, P)
    o = EchelonizeOptions(**opts)
    calls = []
    orig = TENG._Engine.finish_gplu

    def spy(self, *a):
        calls.append(a[2])
        return orig(self, *a)

    monkeypatch.setattr(TENG._Engine, "finish_gplu", spy)
    nat = echelonize(A, o, device="cpu")
    _python_finisher(monkeypatch)
    py = echelonize(A, o, device="cpu")
    assert calls and len(calls) == 2
    _same_factor(nat, py, with_L=o.L or o.complete)


@pytest.mark.parametrize("p", [257, 42013])
@pytest.mark.parametrize("name", ALL_TEST_MATRICES)
def test_gplu_rank_matches_jax(name, p):
    """enable_dense=False: whatever the rounds leave goes to GPLU."""
    J, _ = jsio.load_csr(MATRIX / name, p)
    A, _ = sio.load_csr(MATRIX / name, p)
    _same_factor(jechelonize(J, JOpts(enable_dense=False)),
                 echelonize(A, EchelonizeOptions(enable_dense=False),
                            device="cpu"))


@pytest.mark.parametrize("name", ["mat364.sms", "trefethen_500.sms",
                                  "BIOMD0000000525.int.mpl.sms", "dm2.sms",
                                  "singular2.sms", "medium.sms"])
@pytest.mark.parametrize("complete", [False, True])
def test_gplu_l_mode_matches_jax(name, complete):
    """GPLU in L mode (every row solved, its coefficients into L)."""
    J, _ = jsio.load_csr(MATRIX / name, P)
    A, _ = sio.load_csr(MATRIX / name, P)
    kw = dict(enable_dense=False, L=True, complete=complete)
    _same_factor(jechelonize(J, JOpts(**kw)),
                 echelonize(A, EchelonizeOptions(**kw), device="cpu"),
                 with_L=True)
