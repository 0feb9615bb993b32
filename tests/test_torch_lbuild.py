"""L's CSR assembly (`_LBuilder.build`): torch on the device where the
pending factor blocks are, on the CPU when there are none, held array
for array to the host path it replaced (`COO.from_entries` + `tocsr` +
`resize`, kept here as the oracle), at every digit tier of the prime.

The cases on "cuda" are marked `cuda` and skip without a card; the file
imports JAX only inside the one test that compares with the JAX
package, so the card's cases run with --noconftest -m cuda."""
import re

import numpy as np
import pytest
import torch

from spasm_tpu_torch import CSR, EchelonizeOptions, echelonize
from spasm_tpu_torch.csr import COO
from spasm_tpu_torch.echelonize import _LBuilder, _nonzero_triplets

PRIMES = [3, 42013, 65537, 4294967291]
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device(name)


def _host_build(prime, rows, cols, vals, n, ncols) -> CSR:
    """The host build the torch one replaced: lexsort COO -> CSR."""
    cat = (lambda x: np.concatenate(x) if x else np.empty(0, np.int64))
    T = COO.from_entries(n, max(ncols, 1), prime, cat(rows), cat(cols),
                         cat(vals))
    T.n, T.m = n, max(ncols, 1)
    A = T.tocsr()
    A.resize(n, ncols)
    return A


def _old_thunk(X, rows, row_ids, col_ids):
    """A pending block's host triplets as the thunks gave them before:
    the host copy, the row mask, np.nonzero."""
    H = X.cpu().numpy()
    if rows is not None:
        keep = np.zeros(H.shape[0], bool)
        keep[rows] = True
        H = np.where(keep[:, None], H, 0)
    r, c = np.nonzero(H)
    return (np.asarray(row_ids)[r], np.asarray(col_ids)[c],
            H[r, c].astype(np.int64))


def _same(a: CSR, b: CSR):
    assert (a.n, a.m, a.field.p) == (b.n, b.m, b.field.p)
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices),
                 (a.data, b.data)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _batches(rng, p, n, ncols, k):
    """k host batches: unsorted rows, repeated (row, col) pairs within
    and across batches, values that are 0 mod p or far outside the
    balanced range, and some empty batches."""
    out = []
    for b in range(k):
        size = 0 if b % 3 == 2 else int(rng.integers(1, 400))
        r = rng.integers(0, n, size)
        c = rng.integers(0, ncols, size)
        v = rng.integers(-3 * p, 3 * p, size, dtype=np.int64)
        v[rng.random(size) < 0.2] = p * rng.integers(-2, 3)
        if size > 4:     # a run of one (row, col) whose sum is 0 mod p
            r[:3], c[:3] = r[0], c[0]
            v[:3] = [1, p - 2, 1]
        out.append((r, c, v))
    return out


def _blocks(rng, p, n, ncols, dev):
    """Two pending blocks shaped like the dense LU's Cd and Ld: an int32
    block of balanced values and an int64 one of wide unreduced
    integers, rows mapped through a permutation, columns through an
    unsorted map, one of them restricted to a row subset."""
    out = []
    for dtype, lo, hi, rows in ((torch.int32, -(p // 2), p // 2 + 1, None),
                                (torch.int64, -(1 << 40), 1 << 40, "some")):
        B, w = 23, int(rng.integers(1, ncols + 1))
        D = rng.integers(lo, hi, (B, w), dtype=np.int64)
        D[rng.random((B, w)) < 0.6] = 0
        if dtype == torch.int64:
            D[0, :] = p                              # all 0 mod p
        X = torch.from_numpy(D).to(dtype=dtype, device=dev)
        sel = (None if rows is None
               else np.sort(rng.choice(B, B // 2, replace=False)))
        row_ids = rng.permutation(n)[:B]
        col_ids = rng.choice(ncols, w, replace=False)
        out.append((X, sel, row_ids, col_ids))
    return out


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("case", ["host", "blocks", "mixed", "empty",
                                  "no_columns"])
def test_build_equals_host_path(case, prime, device):
    dev = _device(device)
    rng = np.random.default_rng(prime % 1000 + len(case))
    n, ncols = (0, 0) if case == "no_columns" else (57, 41)
    Lb = _LBuilder(prime)
    want = []                        # host triplets in the order added
    ndev = 0                         # of them, those of pending blocks
    if case in ("host", "mixed"):
        for r, c, v in _batches(rng, prime, n, ncols, 7):
            Lb.add_batch(r, c, v)
            want.append((r, c, v))
    if case in ("blocks", "mixed"):
        for X, sel, row_ids, col_ids in _blocks(rng, prime, n, ncols, dev):
            Lb.add_pending(lambda X=X, s=sel, ri=row_ids, ci=col_ids:
                           _nonzero_triplets(X, s, ri, ci))
            want.append(_old_thunk(X, sel, row_ids, col_ids))
            ndev += want[-1][0].size
    if case == "mixed":              # a host entry on a block's (row, col)
        r, c, _ = want[-1]
        Lb.add(int(r[0]), int(c[0]), 5)
        want.append((r[:1], c[:1], np.asarray([5], np.int64)))
    L = Lb.build(n, ncols)
    _same(_host_build(prime, *zip(*want) if want else ([], [], []),
                      n, ncols), L)
    assert Lb.record == {
        "device": (str(torch.empty(0, device=dev).device)
                   if case in ("blocks", "mixed") else "cpu"),
        "device_entries": ndev,
        "host_entries": sum(r.size for r, _, _ in want) - ndev}
    assert not Lb._pending


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("prime", [42013, 4294967291])
def test_flush_pending_keeps_host_triplets(prime, device):
    """A checkpoint reads rows / cols / vals after flush_pending(): the
    host triplets of every block, in the order and values the host
    thunks gave, so the files stay the JAX package's."""
    dev = _device(device)
    rng = np.random.default_rng(prime % 977)
    Lb = _LBuilder(prime)
    want = []
    r, c, v = _batches(rng, prime, 57, 41, 1)[0]
    Lb.add_batch(r, c, v)
    want.append((r, c, v))
    for X, sel, row_ids, col_ids in _blocks(rng, prime, 57, 41, dev):
        Lb.add_pending(lambda X=X, s=sel, ri=row_ids, ci=col_ids:
                       _nonzero_triplets(X, s, ri, ci))
        want.append(_old_thunk(X, sel, row_ids, col_ids))
    Lb.flush_pending()
    assert not Lb._pending and len(Lb.rows) == len(want)
    for got, exp in zip(zip(Lb.rows, Lb.cols, Lb.vals), want):
        for a, b in zip(got, exp):
            assert a.dtype == np.int64 and np.array_equal(a, b)
    _same(_host_build(prime, *zip(*want), 57, 41), Lb.build(57, 41))


def _dense_square(p):
    """300 x 300 at density 0.3: few structural pivots, so a complete
    PLUQ sends a block of >= 2^16 elements to the device LU (as in
    tests/test_torch_spans.py)."""
    rng = np.random.default_rng(3)
    return np.where(rng.random((300, 300)) < 0.3,
                    rng.integers(1, p, (300, 300)), 0)


@pytest.mark.parametrize("complete", [True, False])
@pytest.mark.parametrize("prime", [42013, 4294967291])
def test_echelonize_L_matches_jax(prime, complete, caplog):
    from spasm_tpu import EchelonizeOptions as JOpts
    from spasm_tpu import echelonize as jechelonize
    from spasm_tpu.csr import CSR as JCSR
    D = _dense_square(prime)
    with caplog.at_level("INFO", logger="spasm_tpu_torch"):
        t = echelonize(CSR.from_dense(D, prime),
                       EchelonizeOptions(L=True, complete=complete),
                       device="cpu")
        Lt = t.L
    j = jechelonize(JCSR.from_dense(D, prime),
                    JOpts(L=True, complete=complete))
    _same(j.L, Lt)
    assert np.array_equal(j.p, t.p)
    m = re.search(r"L's CSR built on cpu: (\d+) entries from device "
                  r"blocks, (\d+) from host batches", caplog.text)
    assert m and int(m[1]) > 0
