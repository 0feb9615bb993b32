"""The slice end to end: default-option `echelonize` (round 0, dense Schur
complement, `finish_dense` / `finish_dense_lowrank` / `test_completion`)
and complete PLUQ, the port on the CPU against the JAX package on the
same inputs.  Tolerance 0: ranks, pivot maps, U, L and p are exact."""
import functools
import sys

import numpy as np
import pytest
import torch

from spasm_tpu import EchelonizeOptions as JOpts
from spasm_tpu import echelonize as jechelonize
from spasm_tpu import sio as jsio
from spasm_tpu.csr import CSR as JCSR
from spasm_tpu.gen import matching_complex_boundary as jmcb

from spasm_tpu_torch import CSR, EchelonizeOptions, echelonize, sio
from spasm_tpu_torch.certificate import factorization_verify
from spasm_tpu_torch.gen import matching_complex_boundary as mcb
from spasm_tpu_torch.interop import lu_from_numpy
from tests.conftest import ALL_TEST_MATRICES, MATRIX

torch.set_num_threads(2)
TENG = sys.modules["spasm_tpu_torch.echelonize"]

# round 0 leaves a dense Schur complement on these (finish_dense)
DENSE_SCHUR = ["G2.sms", "chains.sms", "l1.sms", "m1.sms", "mat364.sms",
               "medium.sms", "rectangular_h.sms", "rectangular_l.sms",
               "singular2.sms", "small.sms", "t1.sms", "trefethen_500.sms",
               "trefethen_2000.sms"]


def _same_csr(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices[:a.nnz], b.indices[:b.nnz])
    assert np.array_equal(a.data[:a.nnz], b.data[:b.nnz])


def _same_factor(j, t, with_L=False):
    assert t.r == j.r
    assert np.array_equal(t.qinv, j.qinv)
    _same_csr(j.U, t.U)
    if with_L:
        assert np.array_equal(t.p, j.p) and t.complete == j.complete
        _same_csr(j.L, t.L)


def _lu_product(fact):
    """L @ U mod p, dense (tests/test_lu_solve.py:27-31), exact in int64
    for any p <= 2^32 - 5: L splits into 16-bit halves, so each sum is
    at most r * 2^16 * (p/2) < 2^63."""
    p = fact.U.field.p
    L = fact.L.todense().astype(np.int64)
    U = fact.U.todense().astype(np.int64)
    lo = ((L + (1 << 15)) & 0xFFFF) - (1 << 15)
    hi = (L - lo) >> 16
    X = ((hi @ U) % p * (1 << 16) + lo @ U) % p
    return np.where(X > p // 2, X - p, X).astype(np.int32)


@pytest.mark.parametrize("p", [257, 42013])
@pytest.mark.parametrize("name", DENSE_SCHUR)
def test_default_rank_matches_jax(name, p, caplog):
    J, _ = jsio.load_csr(MATRIX / name, p)
    A, _ = sio.load_csr(MATRIX / name, p)
    with caplog.at_level("INFO", logger="spasm_tpu_torch"):
        t = echelonize(A, device="cpu")
    assert "[dense] done" in caplog.text or "low-rank" in caplog.text
    _same_factor(jechelonize(J), t)


def _tall(p=42013):
    """1500 x 200 of rank 40, dense: round 0 finds too few structural
    pivots (status 2) and the remainder is tall (aspect > 5)."""
    rng = np.random.default_rng(5)
    C = np.where(rng.random((1500, 40)) < 0.5,
                 rng.integers(1, p, (1500, 40)), 0)
    B = np.where(rng.random((40, 200)) < 0.5,
                 rng.integers(1, p, (40, 200)), 0)
    return (C @ B) % p


def test_tall_input_lowrank_and_completion(monkeypatch):
    """Default options: finish_dense_lowrank draws combinations until a
    round finds nothing, then test_completion stops it."""
    D = _tall()
    p = 42013
    seen = []
    orig = TENG._Engine.test_completion

    def spy(self, *a):
        seen.append(orig(self, *a))
        return seen[-1]

    monkeypatch.setattr(TENG._Engine, "test_completion", spy)
    t = echelonize(CSR.from_dense(D, p), device="cpu")
    assert seen == [True] and t.r == 40
    _same_factor(jechelonize(JCSR.from_dense(D, p)), t)


def _synthetic(n=700, seed=7, density=0.01, p=42013):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n, n)) < density,
                    rng.integers(-(p // 2), p // 2 + 1, (n, n)), 0)


def _pluq_inputs(case):
    p = 42013
    if case == "synthetic700":
        D = _synthetic()
        return JCSR.from_dense(D, p), CSR.from_dense(D, p)
    name, p = case
    return (jsio.load_csr(MATRIX / name, p)[0],
            sio.load_csr(MATRIX / name, p)[0])


PLUQ = [("mat364.sms", 42013), ("trefethen_500.sms", 257), "synthetic700",
        # the d = 3 / 4 tiers (int64 products in every eliminator step)
        ("mat364.sms", 65537), ("trefethen_500.sms", 65537),
        ("mat364.sms", 4294967291), ("trefethen_500.sms", 4294967291)]


@functools.lru_cache(maxsize=None)
def _pluq(i):
    J, A = _pluq_inputs(PLUQ[i])
    j = jechelonize(J, JOpts(complete=True))
    t = echelonize(A, EchelonizeOptions(complete=True), device="cpu")
    return J, A, j, t


@pytest.mark.parametrize("i", range(len(PLUQ)))
def test_complete_pluq_matches_jax(i):
    _, _, j, t = _pluq(i)
    _same_factor(j, t, with_L=True)


@pytest.mark.parametrize("i", range(len(PLUQ)))
def test_complete_pluq_is_a_factorization(i):
    _, A, _, t = _pluq(i)
    assert np.array_equal(_lu_product(t), A.todense())
    assert factorization_verify(A, t, 42)


@pytest.mark.parametrize("i", range(len(PLUQ)))
def test_factorization_verify_judges_a_jax_lu(i):
    J, A, j, _ = _pluq(i)
    U, L = j.U, j.L
    fact = lu_from_numpy(
        j.r, (U.n, U.m, A.prime, U.indptr, U.indices, U.data), j.qinv,
        (L.n, L.m, A.prime, L.indptr, L.indices, L.data), j.p, j.complete)
    assert factorization_verify(A, fact, 42)
    data = L.data[:L.nnz].copy()           # one entry of L off by one
    data[0] = A.field.normalize(int(data[0]) + 1)
    broken = lu_from_numpy(
        j.r, (U.n, U.m, A.prime, U.indptr, U.indices, U.data), j.qinv,
        (L.n, L.m, A.prime, L.indptr, L.indices[:L.nnz], data), j.p,
        j.complete)
    assert not factorization_verify(A, broken, 42)


# every fixture, those whose round-0 Schur complement is sparse included
# (round 1 and the finishers then run in L mode)
PLUQ_FIXTURES = ALL_TEST_MATRICES


@pytest.mark.parametrize("name", PLUQ_FIXTURES)
def test_complete_pluq_fixture_matches_jax(name):
    p = 42013
    J, _ = jsio.load_csr(MATRIX / name, p)
    A, _ = sio.load_csr(MATRIX / name, p)
    t = echelonize(A, EchelonizeOptions(complete=True), device="cpu")
    _same_factor(jechelonize(J, JOpts(complete=True)), t, with_L=True)
    assert np.array_equal(_lu_product(t), A.todense())


@pytest.mark.parametrize("p", [42013, 65537, 4294967291])
def test_mk10_complete_pluq_matches_jax(p):
    """mk10.b3 (4725 x 3150): round 0, the L-mode sparse Schur complement
    through the device branch of schur_sparse (4725 x 3150 >= 2^21),
    round 1, then GPLU in L mode; L, U and p bit-equal, A == L @ U by the
    verifier.  In the d = 2, 3 and 4 tiers (at 65537 round 0's sampled
    density, 5.09 %, is above the threshold: finish_dense in L mode)."""
    J, A = jmcb(10, 3, p), mcb(10, 3, p)
    if A.n < A.m:
        J, A = J.transpose(), A.transpose()
    t = echelonize(A, EchelonizeOptions(complete=True), device="cpu")
    _same_factor(jechelonize(J, JOpts(complete=True)), t, with_L=True)
    assert t.r == 2564 and t.rounds[0]["pivots"] == 2513
    assert len(t.rounds) == (1 if p == 65537 else 2)
    assert factorization_verify(A, t, 42)


def test_device_lu_block_path_taken(monkeypatch):
    """synthetic700 reaches _dense_lu_block_device; mat364 the host block."""
    seen = []
    orig = TENG._Engine._dense_lu_block_device

    def spy(self, *a):
        seen.append(len(a[1]))
        return orig(self, *a)

    monkeypatch.setattr(TENG._Engine, "_dense_lu_block_device", spy)
    _, A = _pluq_inputs("synthetic700")
    echelonize(A, EchelonizeOptions(complete=True), device="cpu")
    assert seen
    n_seen = len(seen)
    _, A = _pluq_inputs(PLUQ[0])
    echelonize(A, EchelonizeOptions(complete=True), device="cpu")
    assert len(seen) == n_seen


@pytest.mark.parametrize("complete", [True, False])
def test_multi_block_l_mode(monkeypatch, complete):
    """Several device L blocks (then a host block, once the free width
    is small): a later block is eliminated against an earlier block's
    composed device chunk with its winv.  The JAX
    package's block budget is a local constant, so no CPU run of it
    splits this input; the port's is a module constant, shrunk here.
    Pinned by properties: A == L @ U exactly (on the pivotal rows unless
    complete), the verifier, and the rank of the JAX run."""
    p = 42013
    D = _synthetic(900, 3, 0.02)
    monkeypatch.setattr(TENG, "_DENSE_ELEM_BUDGET", 0)
    calls = []
    orig = TENG._Engine._dense_lu_block_device

    def spy(self, *a):
        calls.append(len(a[1]))
        return orig(self, *a)

    monkeypatch.setattr(TENG._Engine, "_dense_lu_block_device", spy)
    A = CSR.from_dense(D, p)
    t = echelonize(A, EchelonizeOptions(L=True, complete=complete,
                                        dense_block_size=200), device="cpu")
    assert len(calls) >= 2
    assert t.r == jechelonize(JCSR.from_dense(D, p)).r
    LU_ = _lu_product(t)
    Ad = A.todense()
    if complete:
        assert np.array_equal(LU_, Ad)
    else:
        rows = np.asarray(t.p, np.int64)
        assert np.array_equal(LU_[rows], Ad[rows])
    assert factorization_verify(A, t, 42)


def test_multi_block_rank(monkeypatch):
    """Several RREF blocks: later blocks are eliminated against earlier
    blocks' device chunks; the rank equals the JAX run's."""
    p = 42013
    D = _synthetic(900, 4, 0.02)
    monkeypatch.setattr(TENG, "_DENSE_ELEM_BUDGET", 0)
    t = echelonize(CSR.from_dense(D, p),
                   EchelonizeOptions(dense_block_size=150), device="cpu")
    assert t.r == jechelonize(JCSR.from_dense(D, p)).r
    U = t.U.todense()
    assert np.all(U[t.qinv[t.qinv >= 0], np.nonzero(t.qinv >= 0)[0]] == 1)
