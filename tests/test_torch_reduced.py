"""Kernel B1's plain version, its schedule and the port's ReducedBasis
against the JAX package, on the same inputs (tolerance 0: R is
unique); the plain version of kernel B12 (the block forming's slot
loop) against exact numpy sums."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spasm_tpu import sio as jsio
from spasm_tpu.dense.reduced import ReducedBasis as JReducedBasis
from spasm_tpu.dense.subst_pallas import plan_schedule, run_schedule
from spasm_tpu.echelonize import EchelonizeOptions as JOpts
from spasm_tpu.echelonize import _Engine as JEngine
from spasm_tpu.gen import matching_complex_boundary

from chip_checks import combine_inputs
from spasm_tpu_torch import _cuda
from spasm_tpu_torch.dense.elim import _submod
from spasm_tpu_torch.dense.modp import device_field, storage_dtype
from spasm_tpu_torch.dense.reduced import (ReducedBasis, _ref_combine,
                                           gather_combine, subst_schedule)
from spasm_tpu_torch.dense.subst import nred_for, nred_wide, subst_waves
from spasm_tpu_torch.echelonize import EchelonizeOptions, _Engine
from spasm_tpu_torch.interop import csr_from_numpy
from tests.conftest import MATRIX

torch.set_num_threads(2)
# above the d = 2 tier: the JAX package builds R by its XLA scan there
WIDE = [65521, 65537, 16711421, 16711427, 67108859, 4294967291]


def _random_dag(rng, n, max_refs):
    """Rows 0..n-1 in processing order; row i refs only rows < i."""
    ref_rows, ref_ptr = [], [0]
    for i in range(n):
        k = min(int(rng.integers(0, max_refs + 1)) if i else 0, i)
        refs = rng.choice(i, size=k, replace=False) if k else []
        ref_rows.extend(int(r) for r in refs)
        ref_ptr.append(len(ref_rows))
    return np.asarray(ref_rows, np.int64), np.asarray(ref_ptr, np.int64)


def _waves(ref_rows, ref_ptr, n):
    """Topological levels of the DAG -> the kernel's wave arrays."""
    lev = np.zeros(n, np.int64)
    for i in range(n):
        r = ref_rows[ref_ptr[i]:ref_ptr[i + 1]]
        if r.size:
            lev[i] = lev[r].max() + 1
    order = np.argsort(lev, kind="stable")
    cnt = np.diff(ref_ptr)[order]
    ptr = np.concatenate(([0], np.cumsum(cnt)))
    refs = np.concatenate([ref_rows[ref_ptr[i]:ref_ptr[i + 1]]
                           for i in order])
    bounds = np.concatenate(([0], np.nonzero(np.diff(lev[order]))[0] + 1,
                             [n]))
    return order, ptr, refs, bounds


@pytest.mark.parametrize("p", [257, 42013, 65279])
def test_subst_plain_matches_interpret(p):
    rng = np.random.default_rng(p)
    npad, M, n = 128, 2048, 60
    ref_rows, ref_ptr = _random_dag(rng, n, 4)
    coef = rng.integers(-(p // 2), p // 2 + 1,
                        ref_rows.size).astype(np.int32)
    rowid, refs, cf, KR = plan_schedule(np.arange(n, dtype=np.int64),
                                        ref_rows, ref_ptr, coef, npad)
    R0 = rng.integers(-(p // 2), p // 2 + 1, (npad, M)).astype(np.int16)
    R0[npad - 1] = 0
    want = np.asarray(run_schedule(jnp.asarray(R0), rowid, refs, cf, KR,
                                   p, interpret=True))
    order, ptr, wrefs, bounds = _waves(ref_rows, ref_ptr, n)
    coef_by_row = [coef[ref_ptr[i]:ref_ptr[i + 1]] for i in order]
    wcoef = np.concatenate(coef_by_row).astype(np.int32)
    R = torch.from_numpy(R0.copy())
    subst_waves(R, order, ptr, wrefs, wcoef, bounds, p)
    assert np.array_equal(R.numpy(), want)


def test_nred_bounds():
    for p in (3, 257, 42013, 65279, 65521, 65535):
        assert nred_for(p) * (p // 2) ** 2 < (1 << 31) - p
    for p in WIDE:
        assert nred_wide(p) * (p // 2) ** 2 <= (1 << 63) - 2 * p
    assert nred_for(65521) == 2 and nred_wide(4294967291) == 2
    assert nred_wide(65537) == nred_wide(16711421) == 16


@pytest.mark.parametrize("p", WIDE)
def test_subst_plain_wide_matches_numpy(p):
    """B1's plain version on R's storage (int32 for p > 65535, int16 at
    65521) against a row by row oracle in Python ints, over several
    waves of a random DAG with repeated references; the other storage
    type raises."""
    rng = np.random.default_rng(p)
    npad, M, n = 96, 64, 70
    k = np.minimum(rng.integers(0, 7, n), np.arange(n))
    ref_ptr = np.concatenate(([0], np.cumsum(k)))
    ref_rows = np.concatenate([rng.integers(0, max(i, 1), k[i])
                               for i in range(n)]).astype(np.int64)
    order, ptr, wrefs, bounds = _waves(ref_rows, ref_ptr, n)
    coef = rng.integers(-(p // 2), p // 2 + 1, wrefs.size)
    coef[::3] = p // 2
    R0 = rng.integers(-(p // 2), p // 2 + 1, (npad, M))
    R0[npad - 1] = 0
    want = [[int(x) for x in r] for r in R0]
    for pos, row in enumerate(order):
        for s in range(ptr[pos], ptr[pos + 1]):
            src = want[wrefs[s]]
            want[row] = [a - int(coef[s]) * b for a, b in
                         zip(want[row], src)]
        want[row] = [(a + p // 2) % p - p // 2 for a in want[row]]
    dtype = storage_dtype(p)
    R = torch.from_numpy(R0).to(dtype)
    subst_waves(R, order, ptr, wrefs, coef.astype(np.int32), bounds, p)
    assert np.array_equal(R.numpy(), np.asarray(want))
    other = torch.int32 if dtype == torch.int16 else torch.int16
    with pytest.raises(ValueError, match="contiguous 2-D"):
        subst_waves(R.to(other), order, ptr, wrefs, coef.astype(np.int32),
                    bounds, p)


def _both_engines(A, p):
    je = JEngine(A, JOpts())
    je.extract_structural(A, None)
    B = csr_from_numpy(A.n, A.m, p, A.indptr, A.indices, A.data)
    te = _Engine(B, EchelonizeOptions(), "cpu")
    te.extract_structural(B)
    return je, te, B


def _fixture_mk9():
    return matching_complex_boundary(9, 3).transpose()


@pytest.mark.parametrize("src,p", [("mat364.sms", 42013), ("l1.sms", 3),
                                   ("mk9.3T", 65269), ("mk9.3T", 257)]
                         + [("mk9.3T", p) for p in WIDE])
def test_reduced_basis_R_matches_jax(src, p):
    if src == "mk9.3T":
        A = _fixture_mk9()
        if p != A.prime:
            A, _ = jsio.load_csr(_save(A, p), p)
    else:
        A, _ = jsio.load_csr(MATRIX / src, p)
    je, te, _ = _both_engines(A, p)
    fj, ft = je.U.flat_store(), te.U.flat_store()
    for a, b in zip(fj, ft):
        assert np.array_equal(a, b)
    assert int(fj[4].max()) + 1 >= 3              # >= 3 levels
    qfree = np.nonzero(je.U.qinv < 0)[0]
    jrb = JReducedBasis(A.m, p, qfree, je.U.n)
    jrb.build(*fj)
    trb = ReducedBasis(A.m, p, qfree, te.U.n, "cpu")
    trb.build(*ft)
    assert np.array_equal(trb.R.numpy(), np.asarray(jrb.R))
    assert not trb.R[:, -1].any()                 # dead column stays zero


def _save(A, p):
    import io
    from spasm_tpu.sio import save_csr
    buf = io.StringIO()
    save_csr(A, buf)
    return io.BytesIO(buf.getvalue().encode())


@pytest.mark.parametrize("p", [42013, 65537, 4294967291])
@pytest.mark.parametrize("weighted", [False, True])
def test_form_block_on_jax_R(weighted, p):
    A, _ = jsio.load_csr(MATRIX / "mat364.sms", p)
    je, te, B = _both_engines(A, p)
    qfree = np.nonzero(je.U.qinv < 0)[0]
    jrb = JReducedBasis(A.m, p, qfree, je.U.n)
    jrb.build(*je.U.flat_store())
    jrb.set_entries(A.indices, A.data, A.nnz)
    trb = ReducedBasis.from_numpy(np.asarray(jrb.R), qfree,
                                  je.U.flat_store()[3], A.m, p, "cpu")
    trb.set_entries(B.indices, B.data, B.nnz)
    rng = np.random.default_rng(7)
    rows = rng.integers(0, A.n, (100, 3 if weighted else 1))
    coeffs = (rng.integers(-(p // 2), p // 2 + 1, rows.shape)
              if weighted else None)
    ej, cj = jrb.flat_rows(A.indptr, rows, coeffs)
    et, ct = trb.flat_rows(B.indptr, rows, coeffs)
    assert np.array_equal(ej, et) and np.array_equal(cj, ct)
    want = np.asarray(jrb.form_block(ej, cj, Bp=128))
    got = trb.form_block(et, ct, Bp=128).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("p", [257, 42013])
@pytest.mark.parametrize("src", ["mat364.sms", "l1.sms", "u1.sms",
                                 "trefethen_500.sms", "dm.sms",
                                 "example.sms"])
def test_subst_schedule_matches_jax(src, p):
    """B1's schedule of a fixture's structural pivots: unique rows, every
    reference in a strictly earlier wave, balanced coefficients; the
    scattered free entries substituted over it (plain version) give the
    JAX package's R."""
    A, _ = jsio.load_csr(MATRIX / src, p)
    je, te, _ = _both_engines(A, p)
    offs, cols, vals, pivcols, groups = te.U.flat_store()
    qfree = np.nonzero(je.U.qinv < 0)[0]
    rb = ReducedBasis(A.m, p, qfree, te.U.n, "cpu")
    npad = rb.npad
    pivmap = np.full(A.m + 1, npad - 1, np.int64)
    pivmap[pivcols] = np.arange(len(pivcols))
    rows, ref_ptr, refs, coef, bounds = subst_schedule(
        offs, cols, vals, pivcols, groups, pivmap, npad)
    assert rows.size and np.unique(rows).size == rows.size
    assert bounds[0] == 0 and bounds[-1] == rows.size
    assert np.all(np.diff(bounds) > 0)
    wave = np.full(npad, -1)                  # rows without references: -1
    wave[rows] = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    assert np.all(wave[refs] < np.repeat(wave[rows], np.diff(ref_ptr)))
    assert np.all(np.abs(coef) <= p // 2)
    # each basis row's free entries scattered into the compact R
    colmap = np.full(A.m + 1, rb.M - 1, np.int64)
    colmap[qfree] = np.arange(qfree.size)
    R = torch.zeros((npad, rb.M), dtype=torch.int16)
    for i in range(len(pivcols)):
        c = cols[offs[i]:offs[i + 1]]
        free = pivmap[c] == npad - 1
        R[i, torch.from_numpy(colmap[c[free]])] = torch.from_numpy(
            vals[offs[i]:offs[i + 1]][free].astype(np.int16))
    subst_waves(R, rows, ref_ptr, refs, coef, bounds, p)
    jrb = JReducedBasis(A.m, p, qfree, je.U.n)
    jrb.build(*je.U.flat_store())
    assert np.array_equal(R.numpy(), np.asarray(jrb.R))


def _combine_np(X, V, R, refs, p):
    """Balanced X - sum_k V[:, k] R[refs[:, k]] mod p, exact in int64:
    each product (< 2^62) reduced before the sum."""
    s = ((V[:, :, None].astype(np.int64) * R[refs]) % p).sum(axis=1) % p
    out = (X.astype(np.int64) - s) % p
    return np.where(out > p // 2, out - p, out)


@pytest.mark.parametrize("p,K", [(p, K) for p in WIDE for K in (8, 1104)]
                         + [(p, (1 << 15) + 40) for p in WIDE
                            if device_field(p).ndigits == 3])
def test_ref_combine_plain_matches_exact_sums(p, K):
    """The slot loop that CPU tensors take at d >= 3 (and kernel B12's
    oracle on the card): mostly dead slots, a row of dead slots only,
    the largest coefficients on every slot, and more than 2^15 slots
    at d = 3, where the loop reduces every 2^15 products."""
    S, w = (5, 64) if K > 1 << 15 else (37, 256)
    X, V, R, refs = combine_inputs(np.random.default_rng([p, K]), S, K, w,
                                   p)
    got = _submod(torch.from_numpy(X), _ref_combine(
        torch.from_numpy(V), torch.from_numpy(R).to(storage_dtype(p)),
        torch.from_numpy(refs), p), p)
    assert np.array_equal(got.numpy(), _combine_np(X, V, R, refs, p))


@pytest.mark.parametrize("p", WIDE)
def test_form_block_on_cpu_takes_the_plain_loop(p):
    """A CPU basis forms its blocks through the slot loop at every
    d >= 3 prime, one row per slot-sum against the exact numpy sum;
    kernel B12 is never counted, and its wrapper refuses CPU tensors."""
    rng = np.random.default_rng(p)
    m, nq, npiv = 700, 300, 200
    cols = rng.permutation(m)
    qfree, pivcols = np.sort(cols[:nq]), cols[nq:nq + npiv]
    rb = ReducedBasis(m, p, qfree, npiv, "cpu")
    R = np.zeros((rb.npad, rb.M), np.int64)
    R[:npiv, :nq] = rng.integers(-(p // 2), p // 2 + 1, (npiv, nq))
    rb = ReducedBasis.from_numpy(R, qfree, pivcols, m, p, "cpu")
    nnz = 3000
    indices = rng.integers(0, m, nnz)
    data = rng.integers(-(p // 2), p // 2 + 1, nnz)
    rb.set_entries(indices, data, nnz)
    eidx = rng.integers(0, nnz + 1, (50, 24))
    coeff = rng.integers(-(p // 2), p // 2 + 1, (50, 24)).astype(np.int32)
    before = _cuda.launches["B12"]
    got = rb.form_block(eidx, coeff, Bp=64).numpy()
    assert _cuda.launches["B12"] == before
    assert not got[50:].any() and not got[:, -1].any()
    # the block by definition: every slot's entry times its coefficient,
    # a free column's to its compact column, a pivot column's through R
    v = (data.astype(object)[np.minimum(eidx, nnz - 1)] * coeff) % p
    v[eidx == nnz] = 0
    c = indices[np.minimum(eidx, nnz - 1)]
    want = np.zeros((50, rb.M), object)
    slot = {int(q): i for i, q in enumerate(qfree)}
    row = {int(q): i for i, q in enumerate(pivcols)}
    for b in range(50):
        for k in range(24):
            if eidx[b, k] == nnz:
                continue
            if int(c[b, k]) in slot:
                want[b, slot[int(c[b, k])]] += v[b, k]
            elif int(c[b, k]) in row:
                want[b] -= v[b, k] * R[row[int(c[b, k])]].astype(object)
    want %= p
    want = np.where(want > p // 2, want - p, want).astype(np.int64)
    want[:, -1] = 0
    assert np.array_equal(got[:50], want)
    X = torch.zeros((4, rb.M), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_combine(X, torch.zeros((4, 8), dtype=torch.int32), rb.R,
                       torch.zeros((4, 8), dtype=torch.int64), p,
                       rb.npad - 1, True)
