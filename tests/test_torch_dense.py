"""The port's dense elimination (dense/elim.py), chunked eliminator
(dense/block.py) and dense Schur blocks (schur.py) against the JAX
package on the same numpy-made inputs, on the CPU (B4 through its plain
version, the JAX side through its XLA path).  Tolerance 0."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spasm_tpu import EchelonizeOptions as JOpts
from spasm_tpu import sio as jsio
from spasm_tpu.dense import block as jblock
from spasm_tpu.dense import elim as jelim
from spasm_tpu.dense.modp import device_field
from spasm_tpu import schur as jschur

from spasm_tpu_torch import EchelonizeOptions, sio
from spasm_tpu_torch import schur
from spasm_tpu_torch.dense import block, elim
from tests.conftest import MATRIX

torch.set_num_threads(2)
P = 42013
# above the d = 2 tier: both ends of d = 3 (65521 stored int16) and d = 4
WIDE = [65521, 65537, 16711421, 16711427, 67108859, 4294967291]
JENG = sys.modules["spasm_tpu.echelonize"]
TENG = sys.modules["spasm_tpu_torch.echelonize"]


def _low_rank(rng, n, m, r, p=P):
    X = (rng.integers(0, p, (n, r)) @ rng.integers(0, p, (r, m))) % p
    X[rng.random(n) < 0.1] = 0
    return np.where(X > p // 2, X - p, X).astype(np.int32)


@pytest.mark.parametrize("rref", [True, False])
@pytest.mark.parametrize("shape,r", [((256, 512), 200), ((200, 1024), 150)])
def test_eliminate_matches_jax(shape, r, rref):
    """(256, 512): one 512-column block; (200, 1024): two blocks, so the
    composed trailing update runs.  Bit-equal S, pivot map, is_piv, L."""
    n, m = shape
    X = _low_rank(np.random.default_rng([n, m]), n, m, r)
    F = device_field(P)
    jS, jpiv, jis, jL = jelim._eliminate(
        jnp.asarray(jelim._pad(X, 64)), jnp.int64(P), jnp.asarray(F.weights),
        F.ndigits, rref, 64, True, False)
    tS, tpiv, tis, tL = elim._eliminate(elim._pad(torch.from_numpy(X), 64),
                                        P, rref)
    assert np.array_equal(np.asarray(jS)[:n], tS.numpy()[:n])
    assert np.array_equal(np.asarray(jpiv), tpiv.numpy())
    assert np.array_equal(np.asarray(jis)[:n], tis.numpy()[:n])
    assert int((tpiv >= 0).sum()) == r
    if not rref:
        assert np.array_equal(np.asarray(jL)[:n], tL.numpy()[:n])


@pytest.mark.parametrize("shape", [(256, 512), (200, 600)])
def test_device_entry_points_match_jax(shape):
    n, m = shape
    X = _low_rank(np.random.default_rng(list(shape)), n, m, 180)
    jR, jpc = jelim.dense_rref_device(jnp.asarray(X), P)
    tR, tpc = elim.dense_rref_device(torch.from_numpy(X), P)
    assert np.array_equal(jpc, tpc)
    assert np.array_equal(np.asarray(jR), tR.numpy())
    jlu = jelim.dense_lu_device(jnp.asarray(X), P)
    tlu = elim.dense_lu_device(torch.from_numpy(X), P)
    for a, b in zip(jlu[:2], tlu[:2]):
        assert np.array_equal(a, b)
    for a, b in zip(jlu[2:], tlu[2:]):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("shape", [(100, 200), (300, 300)])
def test_host_entry_points_match_jax(shape):
    """Both sides of _HOST_LIMIT (20000 and 90000 elements)."""
    n, m = shape
    X = _low_rank(np.random.default_rng([n, 7]), n, m, 80)
    assert (X.size <= elim._HOST_LIMIT) == (X.size <= jelim._HOST_LIMIT)
    jR, jpc = jelim.dense_rref(X, P)
    tR, tpc = elim.dense_rref(X, P, device="cpu")
    assert np.array_equal(jR, tR) and np.array_equal(jpc, tpc)
    jlu = jelim.dense_lu(X, P)
    tlu = elim.dense_lu(X, P, device="cpu")
    assert jlu[0] == tlu[0] == 80
    for a, b in zip(jlu[1:], tlu[1:]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert jelim.dense_rank(X, P) == elim.dense_rank(X, P, device="cpu") == 80


def _low_rank_wide(rng, n, m, r, p):
    """Rank <= r balanced int32 block for any p <= 2^32 - 5: small left
    factors keep the int64 products exact."""
    X = rng.integers(-3, 4, (n, r)) @ rng.integers(-(p // 2), p // 2 + 1,
                                                    (r, m))
    X[rng.random(n) < 0.1] = 0
    X %= p
    return np.where(X > p // 2, X - p, X).astype(np.int32)


@pytest.mark.parametrize("rref", [True, False])
@pytest.mark.parametrize("p", WIDE)
def test_eliminate_wide_matches_jax(p, rref):
    """Above the d = 2 tier the panels take the torch route (the JAX
    package's use_pallas=False: discovery sweep, Jordan inverse /
    forward factor with int64 products); two 512-column blocks, so the
    composed trailing update runs.  Bit-equal S, pivot map, is_piv, L."""
    n, m = 200, 1024
    X = _low_rank_wide(np.random.default_rng(p), n, m, 150, p)
    F = device_field(p)
    jS, jpiv, jis, jL = jelim._eliminate(
        jnp.asarray(jelim._pad(X, 64)), jnp.int64(p), jnp.asarray(F.weights),
        F.ndigits, rref, 64, p <= (1 << 23), False)
    tS, tpiv, tis, tL = elim._eliminate(elim._pad(torch.from_numpy(X), 64),
                                        p, rref)
    assert np.array_equal(np.asarray(jS)[:n], tS.numpy()[:n])
    assert np.array_equal(np.asarray(jpiv), tpiv.numpy())
    assert np.array_equal(np.asarray(jis)[:n], tis.numpy()[:n])
    assert int((tpiv >= 0).sum()) == 150
    if not rref:
        assert np.array_equal(np.asarray(jL)[:n], tL.numpy()[:n])


@pytest.mark.parametrize("p", WIDE)
def test_dense_entry_points_wide_match_jax(p):
    """dense_rref / dense_lu through `_run` (force="device") and the
    device-resident entry points, at (120, 256), against the JAX
    package's."""
    X = _low_rank_wide(np.random.default_rng([p, 3]), 120, 256, 80, p)
    jR, jpc = jelim.dense_rref(X, p, force="device")
    tR, tpc = elim.dense_rref(X, p, force="device", device="cpu")
    assert np.array_equal(jR, tR) and np.array_equal(jpc, tpc)
    jlu = jelim.dense_lu(X, p, force="device")
    tlu = elim.dense_lu(X, p, force="device", device="cpu")
    assert jlu[0] == tlu[0] == 80
    for a, b in zip(jlu[1:], tlu[1:]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    jR, jpc = jelim.dense_rref_device(jnp.asarray(X), p)
    tR, tpc = elim.dense_rref_device(torch.from_numpy(X), p)
    assert np.array_equal(jpc, tpc)
    assert np.array_equal(np.asarray(jR), tR.numpy())
    jlu = jelim.dense_lu_device(jnp.asarray(X), p)
    tlu = elim.dense_lu_device(torch.from_numpy(X), p)
    for a, b in zip(jlu[:2], tlu[:2]):
        assert np.array_equal(a, b)
    for a, b in zip(jlu[2:], tlu[2:]):
        assert np.array_equal(np.asarray(a), b.numpy())


def _chunk_rows(rng, m, k, p=P):
    """k pivot-first rows (value 1 at pivcol) over m columns; each row
    also holds later rows' pivot columns, so the chunk's rows interact."""
    piv = rng.choice(m, k, replace=False)
    rows = []
    for i in range(k):
        extra = rng.choice(m, 6, replace=False)
        later = piv[i + 1:i + 3]
        cols = np.unique(np.concatenate(([piv[i]], extra, later)))
        cols = cols[~np.isin(cols, piv[:i])]          # upper triangular
        vals = rng.integers(-(p // 2), p // 2 + 1, cols.size)
        vals[cols == piv[i]] = 1
        rows.append((cols.astype(np.int64), vals.astype(np.int32),
                     int(piv[i])))
    return rows


@pytest.mark.parametrize("P", [P, 65537, 4294967291])
@pytest.mark.parametrize("park", [True, False])
def test_ueliminator_matches_jax(park, P):
    """Interacting rows compose their chunk ((I + W)^-1 and its winv
    parking); a second, independent segment with levels stacks into a
    run; a device chunk closes the basis.  At 42013 and in the d = 3 / 4
    tiers."""
    rng = np.random.default_rng(11)
    m = 300
    rows = _chunk_rows(rng, m, 40, P)
    used = np.concatenate([c for c, _, _ in rows])
    free = np.setdiff1d(np.arange(m), used)
    piv2 = free[:20]
    rows2 = [(np.asarray([c], np.int64), np.asarray([1], np.int32), int(c))
             for c in piv2]
    free2 = free[20:]
    Vd = np.zeros((5, free2.size), np.int32)
    Vd[:, :5] = np.eye(5, dtype=np.int32)
    Vd[:, 5:] = rng.integers(-(P // 2), P // 2 + 1, (5, free2.size - 5))
    X = rng.integers(-(P // 2), P // 2 + 1, (37, m)).astype(np.int32)
    got, elims = {}, {}
    for tag, mod, arr in (("jax", jblock, jnp.asarray),
                          ("torch", block, torch.from_numpy)):
        E = mod.UEliminator(m, P) if tag == "jax" else \
            mod.UEliminator(m, P, "cpu")
        E.append_rows(rows, flush=False)
        E.append_rows(rows2, flush=False, levels=[0] * len(rows2))
        E.append_device_chunk(arr(Vd), free2, np.arange(5))
        Xd = E.eliminate_device(E.pad_block(X), park=park)
        got[tag] = (np.asarray(Xd[:37, :m]), np.asarray(E.eliminate(X)))
        elims[tag] = E
    assert any(r.winv is not None for r in elims["torch"].runs)
    for a, b in zip(got["jax"], got["torch"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("P", [P, 65537, 16711427, 4294967291])
def test_unit_upper_inverse_log_matches_jax(P):
    rng = np.random.default_rng(3)
    W = np.triu(rng.integers(-(P // 2), P // 2 + 1, (70, 70)), 1)
    F = device_field(P)
    want = jblock._unit_upper_inverse_log(jnp.asarray(W, jnp.int32),
                                          jnp.int64(P),
                                          jnp.asarray(F.weights), F.ndigits)
    got = block._unit_upper_inverse_log(torch.from_numpy(W).to(torch.int32),
                                        P)
    assert np.array_equal(np.asarray(want), got.numpy())


def _engines(name, p=P):
    """Both packages' engines after round 0's structural pivots (L mode:
    the eliminator holds the pivot rows, staged)."""
    J, _ = jsio.load_csr(MATRIX / name, p)
    A, _ = sio.load_csr(MATRIX / name, p)
    je = JENG._Engine(J, JOpts(L=True))
    _, jp = je.extract_structural(J, None)
    te = TENG._Engine(A, EchelonizeOptions(L=True), "cpu")
    _, tp = te.extract_structural(A)
    assert np.array_equal(jp, tp)
    return J, je, A, te, tp


@pytest.mark.parametrize("want_L", [True, False])
def test_schur_dense_block_device_matches_jax(want_L):
    J, je, A, te, p = _engines("mat364.sms")
    rows = p[te.U.n:]
    jout = jschur.schur_dense_block_device(J, rows, None, je.U.qinv, je.elim,
                                           want_L=want_L)
    tout = schur.schur_dense_block_device(A, rows, None, te.U.qinv, te.elim,
                                          want_L=want_L)
    assert np.array_equal(np.asarray(jout[0]), tout[0].numpy())
    assert np.array_equal(jout[1], tout[1])
    assert np.array_equal(jout[2], tout[2])
    if want_L:
        assert np.array_equal(np.asarray(jout[3][0]), tout[3][0].numpy())
        assert np.array_equal(jout[3][1], tout[3][1])


@pytest.mark.parametrize("name", ["mat364.sms", "trefethen_500.sms",
                                  "medium.sms"])
def test_estimate_density_matches_jax(name):
    J, je, A, te, p = _engines(name)
    npiv = te.U.n
    want = jschur.estimate_density(J, p[npiv:], J.n - npiv,
                                   je.U.snapshot_csr(), je.U.qinv, 100,
                                   seed=1)
    got = schur.estimate_density(A, p[npiv:], A.n - npiv,
                                 te.U.snapshot_csr(), te.U.qinv, 100, seed=1)
    assert got == want and got > 0
