"""The sparse Schur complement of a round: the nonzero packing, the
device row blocks (`DeviceCSR.densify`), both branches of `schur_sparse`
(with and without L) and `_Engine.schur_sparse_reduced`, the port on the
CPU against the JAX package on the same inputs.  Tolerance 0: S, p_out
and the L triplets are exact.

The Schur inputs are mk10.b3 (`matching_complex_boundary(10, 3)`, 4725 x
3150, as the rank tool orients it) after its 2513 round-0 structural
pivots, the state from which both packages run round 1."""
import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spasm_tpu.csr import CSR as JCSR
from spasm_tpu.device_csr import DeviceCSR as JDeviceCSR
from spasm_tpu.echelonize import EchelonizeOptions as JOpts
from spasm_tpu.field import Field as JField
from spasm_tpu.echelonize import LU as JLU
from spasm_tpu.echelonize import _Engine as JEngine
from spasm_tpu.echelonize import _LBuilder as JLBuilder
from spasm_tpu.gen import matching_complex_boundary as jmcb
from spasm_tpu.schur import _pack_nonzero_device as j_pack
from spasm_tpu.schur import schur_sparse as j_schur_sparse

from spasm_tpu_torch.csr import CSR
from spasm_tpu_torch.device_csr import DeviceCSR
from spasm_tpu_torch.echelonize import LU, EchelonizeOptions, _Engine
from spasm_tpu_torch.echelonize import _LBuilder
from spasm_tpu_torch.field import Field
from spasm_tpu_torch.gen import matching_complex_boundary as mcb
from spasm_tpu_torch.schur import _pack_nonzero_device, schur_sparse

torch.set_num_threads(2)
P = 42013


def _same_csr(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    assert np.array_equal(a.indptr[:a.n + 1], b.indptr[:b.n + 1])
    assert np.array_equal(a.indices[:a.nnz], b.indices[:b.nnz])
    assert np.array_equal(a.data[:a.nnz], b.data[:b.nnz])


def _block(rng, B, Bp, m, mp, p):
    """(Bp, mp) balanced int32 block: zero rows, nonzeros in the padded
    rows past B and in the dead columns past m (the packing drops both)."""
    X = rng.integers(-(p // 2), p // 2 + 1, (Bp, mp)).astype(np.int32)
    X[rng.random((Bp, mp)) < 0.9] = 0
    X[::5] = 0
    X[B:, :] = 7
    X[:, m:] = -3
    return X


@pytest.mark.parametrize("B,Bp,m,mp", [(40, 48, 100, 128), (1, 8, 7, 64),
                                       (64, 64, 960, 1024), (5, 8, 64, 64)])
@pytest.mark.parametrize("p", [3, 42013])
def test_pack_nonzero_matches_jax(B, Bp, m, mp, p):
    X = _block(np.random.default_rng([B, m, p]), B, Bp, m, mp, p)
    want = j_pack(jnp.asarray(X), B, m)
    got = _pack_nonzero_device(torch.from_numpy(X), B, m)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    assert got[0].size == np.count_nonzero(X[:B, :m])


def test_pack_nonzero_empty():
    X = np.zeros((8, 64), np.int32)
    X[:, 63] = 5
    for a in _pack_nonzero_device(torch.from_numpy(X), 8, 63):
        assert a.size == 0


def _dup_csr(seed, n, m, p, csr_cls, field_cls):
    """n x m CSR whose rows repeat columns (duplicate entries); values up
    to p // 16, so a row's sums stay balanced and the JAX package's int16
    sums need no reduction."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, n)
    indptr = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    cols = rng.integers(0, m, int(indptr[-1]))
    cols[1::3] = cols[::3][:cols[1::3].size]          # repeats
    vals = rng.integers(-(p // 16), p // 16 + 1, cols.size)
    return csr_cls(n, m, field_cls(p), indptr, cols.astype(np.int32),
                   vals.astype(np.int32))


@pytest.mark.parametrize("p", [257, 42013, 65269])
@pytest.mark.parametrize("mp", [None, 320])
def test_densify_matches_jax(p, mp):
    """Duplicate column entries sum, the dead last column stays zero, the
    rows past len(rows) are zero; the port's block is int32 (the JAX
    package's int16 values, widened)."""
    rng = np.random.default_rng(p)
    J = _dup_csr(p, 50, 300, p, JCSR, JField)
    A = _dup_csr(p, 50, 300, p, CSR, Field)
    rows = rng.permutation(50)[:37]
    want = np.asarray(JDeviceCSR(J, mp=mp).densify(rows, Bp=40))
    got = DeviceCSR(A, device="cpu", mp=mp).densify(rows, Bp=40)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int32),
                          want.astype(np.int32))
    assert not got[:, -1].any() and not got[37:].any()
    assert got.shape == (40, 512 if mp is None else mp)


def test_densify_reduces_large_duplicate_sums():
    """Where duplicates sum past p/2 the port reduces once mod p."""
    p = 257
    A = CSR(1, 4, Field(p), np.array([0, 3]), np.array([2, 2, 2], np.int32),
            np.array([100, 100, 100], np.int32))
    X = DeviceCSR(A, device="cpu").densify(np.array([0]))
    assert X[0, 2] == 300 - p and X.dtype == torch.int32


@pytest.mark.parametrize("p", [65537, 16711421, 16711427, 4294967291])
def test_densify_wide_duplicate_sums_match_numpy(p):
    """Above the d = 2 tier duplicates sum in int64 and reduce once (at
    2^32 - 5 the sums pass 2^31), and the block equals a
    numpy int64 oracle (not the JAX _densify, which sums in int16
    unreduced: ROADMAP C8)."""
    rng = np.random.default_rng(p)
    n, m = 30, 90
    lens = rng.integers(0, 12, n)
    indptr = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    cols = rng.integers(0, 9, int(indptr[-1]))        # many duplicates
    vals = rng.integers(p // 2 - 1000, p // 2 + 1, cols.size)
    vals[::2] *= -1
    vals[5::7] = p // 2
    A = CSR(n, m, Field(p), indptr, cols.astype(np.int32),
            vals.astype(np.int32))
    rows = rng.permutation(n)[:25]
    want = np.zeros((32, 128), np.int64)
    for k, i in enumerate(rows):
        np.add.at(want[k], cols[indptr[i]:indptr[i + 1]],
                  vals[indptr[i]:indptr[i + 1]])
    assert np.abs(want).max() > p // 2
    assert p < 1 << 31 or np.abs(want).max() >= 1 << 31
    want = want % p
    want = np.where(want > p // 2, want - p, want)
    got = DeviceCSR(A, device="cpu").densify(rows, Bp=32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def _mk10():
    J, A = jmcb(10, 3), mcb(10, 3)
    if A.n < A.m:                                # the rank tool's side
        J, A = J.transpose(), A.transpose()
    return J, A


@functools.lru_cache(maxsize=None)
def _round0(want_L: bool):
    """Both engines after round 0 of mk10.b3: (J, A, jeng, teng, jp, tp,
    npiv)."""
    J, A = _mk10()
    jeng = JEngine(J, JOpts(L=want_L))
    teng = _Engine(A, EchelonizeOptions(L=want_L), "cpu")
    jn, jp = jeng.extract_structural(J, None)
    tn, tp = teng.extract_structural(A, None)
    assert jn == tn == 2513 and np.array_equal(jp, tp)
    return J, A, jeng, teng, jp, tp, tn


def _triplets(L):
    cat = (lambda x: np.concatenate(x) if x else np.empty(0, np.int64))
    return cat(L.rows), cat(L.cols), cat(L.vals)


@pytest.mark.parametrize("use_device", [False, True])
@pytest.mark.parametrize("want_L", [False, True])
def test_schur_sparse_matches_jax(use_device, want_L):
    J, A, jeng, teng, jp, tp, npiv = _round0(want_L)
    n = A.n - npiv
    p_in = np.arange(A.n, dtype=np.int64)[::-1].copy()   # row origins
    jL = JLBuilder(P) if want_L else None
    tL = _LBuilder(P) if want_L else None
    jS, jpo = j_schur_sparse(
        J, jp[npiv:], n, JLU(jeng.U.n, jeng.U.snapshot_csr(), jeng.U.qinv),
        0.0, jL, p_in, eliminator=jeng.elim, use_device=use_device)
    tS, tpo = schur_sparse(
        A, tp[npiv:], n, LU(teng.U.n, teng.U.snapshot_csr(), teng.U.qinv),
        tL, p_in, eliminator=teng.elim, use_device=use_device)
    _same_csr(jS, tS)
    assert tS.nnz == 71608 and np.array_equal(jpo, tpo)
    assert np.array_equal(tpo, p_in[tp[npiv:]])
    if want_L:
        for a, b in zip(_triplets(jL), _triplets(tL)):
            assert np.array_equal(a, b)
        assert _triplets(tL)[0].size > 0


def test_schur_sparse_reduced_matches_jax():
    J, A, jeng, teng, jp, tp, npiv = _round0(False)
    n = A.n - npiv
    p_in = (np.arange(A.n, dtype=np.int64) * 7) % A.n
    jS, jpo = jeng.schur_sparse_reduced(J, jp[npiv:], n, p_in)
    tS, tpo = teng.schur_sparse_reduced(A, tp[npiv:], n, p_in)
    _same_csr(jS, tS)
    assert np.array_equal(jpo, tpo)
    # the same complement as the triangular solves give
    hS, _ = schur_sparse(
        A, tp[npiv:], n, LU(teng.U.n, teng.U.snapshot_csr(), teng.U.qinv),
        None, None, use_device=False)
    _same_csr(hS, tS)


def test_schur_sparse_reduced_blocks(monkeypatch):
    """Several blocks through the one-deep overlap give the same S."""
    TENG = sys.modules["spasm_tpu_torch.echelonize"]
    _, A, _, teng, _, tp, npiv = _round0(False)
    n = A.n - npiv
    whole, _ = teng.schur_sparse_reduced(A, tp[npiv:], n, None)
    monkeypatch.setattr(TENG, "_SCHUR_BLOCK", 300)
    blocked, po = teng.schur_sparse_reduced(A, tp[npiv:], n, None)
    _same_csr(whole, blocked)
    assert np.array_equal(po, tp[npiv:])
