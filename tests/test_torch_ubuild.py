"""U's read (`_UBuilder.flush_device`, `snapshot_csr`, `flat_store`):
the pending dense blocks sparsified with torch where they are, pivot
first in each row, and one copy of their CSR to the host; no levels in
`snapshot_csr`.  Held array for array to the host path it replaced (the
whole block copied, `np.nonzero`, a pivot-first `np.lexsort`; kept here
as the oracle) at every digit tier of the prime, on the CPU and the
card.

The cases on "cuda" are marked `cuda` and skip without a card; the file
does not import JAX, so the card's cases run with --noconftest -m
cuda."""
import re
import sys

import numpy as np
import pytest
import torch

from spasm_tpu_torch import CSR, EchelonizeOptions, echelonize
from spasm_tpu_torch.dense.modp import storage_dtype
from spasm_tpu_torch.echelonize import _intra_levels, _UBuilder

# the module (the package exports its function under the same name)
ech = sys.modules["spasm_tpu_torch.echelonize"]
PRIMES = [3, 42013, 65537, 4294967291]
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
PIVOTS = ["first", "middle", "last"]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device(name)


def _old_flush(self):
    """flush_device as it was: the whole block to the host, np.nonzero,
    then each row's pivot sorted to the front by np.lexsort."""
    if not self._pending:
        return
    pending, self._pending = self._pending, []
    for Rd, colmap, pivcols, _ in pending:
        R = Rd.cpu().numpy()
        K = R.shape[0]
        nz_r, nz_c = np.nonzero(R)
        order_cm = np.argsort(colmap, kind="stable")
        ppos = order_cm[np.searchsorted(colmap, pivcols, sorter=order_cm)]
        first = nz_c == ppos[nz_r]
        order = np.lexsort((~first, nz_r))
        nz_r, nz_c = nz_r[order], nz_c[order]
        counts = np.bincount(nz_r, minlength=K)
        offs = np.concatenate(([0], np.cumsum(counts)))
        self._segs.append((offs.astype(np.int64),
                           colmap[nz_c].astype(np.int32),
                           R[nz_r, nz_c].astype(np.int32), pivcols, None))


class _OldUBuilder(_UBuilder):
    flush_device = _old_flush


def _old_groups(segs) -> np.ndarray:
    """flat_store's groups from the segments: each segment's levels
    (computed by _intra_levels where it has none), offset per segment."""
    out, gid = [], 0
    for offs, cols, _, pivcols, levels in segs:
        if levels is None:
            levels = _intra_levels(offs, cols, pivcols)
        out.append(gid + levels)
        gid += int(levels.max(initial=0)) + 1
    return np.concatenate(out) if out else np.empty(0, np.int64)


def _block(rng, p, m, used, K, w, pivot, dev):
    """A (K, w + 3) block of U rows as the finishers register them: w
    local columns mapped to unused global columns in no order, then 3
    padding columns (colmap == m, all zero); row k has value 1 at its
    pivot's local column, balanced values elsewhere, all of them right
    of the pivot ("first"), left of it ("last") or on both sides
    ("middle"); one row holds its pivot alone.  Stored in the tier's
    dtype.  Returns (Rd, colmap, pivcols)."""
    free = np.setdiff1d(np.arange(m), np.fromiter(used, np.int64,
                                                  len(used)))
    colmap = np.concatenate((rng.choice(free, w, replace=False),
                             np.full(3, m)))
    # the first and the last local column are pivots, and some between
    ppos = np.concatenate(([0, w - 1], rng.choice(np.arange(1, w - 1),
                                                  K - 2, replace=False)))
    rng.shuffle(ppos)
    h = p // 2
    D = rng.integers(-h, h + 1, (K, w + 3), dtype=np.int64)
    D[rng.random((K, w + 3)) < 0.5] = 0
    D[:, w:] = 0
    cols = np.arange(w + 3)
    for k in range(K):
        if pivot == "first":
            D[k, cols < ppos[k]] = 0
        elif pivot == "last":
            D[k, cols > ppos[k]] = 0
        D[k, ppos[k]] = 1
    D[K // 2, :] = 0
    D[K // 2, ppos[K // 2]] = 1
    pivcols = colmap[ppos]
    used.update(pivcols.tolist())
    Rd = torch.from_numpy(D).to(dtype=storage_dtype(p), device=dev)
    return Rd, colmap, pivcols


def _host_rows(rng, p, m, used, K):
    """K pivot-first host rows on unused pivot columns, with levels."""
    piv = rng.choice(np.setdiff1d(np.arange(m), np.fromiter(
        used, np.int64, len(used))), K, replace=False)
    used.update(piv.tolist())
    cols, vals, offs = [], [], [0]
    for j in piv:
        c = np.concatenate(([j], np.setdiff1d(
            rng.choice(m, 5, replace=False), [j])))
        cols.append(c)
        vals.append(np.concatenate(([1], rng.integers(1, p, c.size - 1))))
        offs.append(offs[-1] + c.size)
    return (piv, np.asarray(offs), np.concatenate(cols).astype(np.int32),
            np.concatenate(vals).astype(np.int32),
            rng.integers(0, 3, K))


def _fill(builders, case, pivot, p, dev, seed):
    """The same rows into each builder: pending blocks alone ("blocks"),
    blocks interleaved with host segments whose registration flushes
    the blocks before them, a single row among them ("mixed"), or host
    segments alone ("empty": no block pending).  Returns the entries of
    the device blocks."""
    rng = np.random.default_rng(seed)
    m, used, ndev = 160, set(), 0
    steps = {"blocks": ["block", "block"],
             "mixed": ["block", "block", "host", "block", "row", "block",
                       "host", "block"],
             "empty": ["host", "row", "host"]}[case]
    for step in steps:
        if step == "block":
            K, w = int(rng.integers(3, 12)), int(rng.integers(14, 30))
            Rd, colmap, pivcols = _block(rng, p, m, used, K, w, pivot, dev)
            ndev += int(torch.count_nonzero(Rd))
            for b in builders:
                b.add_dense_rows_device(Rd, colmap, pivcols)
        elif step == "host":
            piv, offs, cols, vals, lev = _host_rows(rng, p, m, used, 4)
            for b in builders:
                b.add_rows_bulk(piv, offs, cols, vals, levels=lev)
        else:
            piv, offs, cols, vals, _ = _host_rows(rng, p, m, used, 1)
            for b in builders:
                b.add_row(int(piv[0]), cols, vals)
    return ndev


def _same(a, b):
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("prime", PRIMES)
@pytest.mark.parametrize("pivot", PIVOTS)
@pytest.mark.parametrize("case", ["blocks", "mixed"])
def test_read_equals_numpy_path(case, pivot, prime, device, monkeypatch):
    dev = _device(device)
    if case == "mixed":                  # several row chunks a block
        monkeypatch.setattr(ech, "_U_CHUNK_ELEMS", 60)
    new, old = _UBuilder(160, prime), _OldUBuilder(160, prime)
    ndev = _fill([new, old], case, pivot, prime, dev, prime % 1000 + 7)
    U, Uo = new.snapshot_csr(), old.snapshot_csr()
    assert (U.n, U.m) == (Uo.n, Uo.m) == (new.n, 160)
    for x, y in ((U.indptr, Uo.indptr), (U.indices, Uo.indices),
                 (U.data, Uo.data)):
        _same(x, y)
    _same(new.qinv, old.qinv)
    assert len(new._segs) == len(old._segs)
    for s, so in zip(new._segs, old._segs):
        for x, y in zip(s[:4], so[:4]):
            _same(x, y)
    assert new.record == {"device": str(torch.empty(0, device=dev).device),
                          "device_entries": ndev,
                          "host_entries": int(U.indptr[-1]) - ndev,
                          "level_rows": 0}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("prime", PRIMES)
def test_nothing_pending(prime, device):
    """Host segments alone: no flush, the record on the CPU."""
    _device(device)
    new, old = _UBuilder(160, prime), _OldUBuilder(160, prime)
    _fill([new, old], "empty", "first", prime, "cpu", 5)
    U, Uo = new.snapshot_csr(), old.snapshot_csr()
    for x, y in ((U.indptr, Uo.indptr), (U.indices, Uo.indices),
                 (U.data, Uo.data)):
        _same(x, y)
    assert new.record == {"device": "cpu", "device_entries": 0,
                          "host_entries": int(U.indptr[-1]),
                          "level_rows": 0}
    empty = _UBuilder(160, prime)
    E = empty.snapshot_csr()
    assert E.n == 0 and list(E.indptr) == [0]
    assert empty.flat_store()[4].size == 0


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("prime", [42013, 4294967291])
def test_flat_store_keeps_the_groups(prime, device):
    """flat_store computes every level-less segment's levels as before
    (the device blocks' included) and returns snapshot_csr's arrays
    first; snapshot_csr computes none."""
    dev = _device(device)
    new, old = _UBuilder(160, prime), _OldUBuilder(160, prime)
    _fill([new, old], "mixed", "middle", prime, dev, 11)
    U = new.snapshot_csr()
    assert new.record["level_rows"] == 0
    got, want = new.flat_store(), old.flat_store()
    for x, y in zip(got, want):
        _same(x, y)
    _same(got[4], _old_groups(old._segs))
    for x, y in zip(got[:3], (U.indptr, U.indices, U.data)):
        _same(x, y)
    assert new.record["level_rows"] == sum(
        len(s[3]) for s in new._segs if s[4] is None) > 0


def test_no_levels_in_the_read(monkeypatch):
    """snapshot_csr never calls _intra_levels; flat_store does."""
    calls = []
    real = ech._intra_levels
    monkeypatch.setattr(ech, "_intra_levels",
                        lambda *a: calls.append(1) or real(*a))
    b = _UBuilder(160, 42013)
    _fill([b], "mixed", "middle", 42013, "cpu", 3)
    b.snapshot_csr()
    assert not calls
    b.flat_store()
    assert calls


def _dense_square(p):
    """300 x 300 at density 0.3: a complete PLUQ sends a block of >=
    2^16 elements to the device LU (_dense_lu_block_device)."""
    rng = np.random.default_rng(3)
    return CSR.from_dense(np.where(rng.random((300, 300)) < 0.3,
                                   rng.integers(1, p, (300, 300)), 0), p)


def _tall_lowrank(p):
    """Rank <= 40 under 1500 rows: the rank finisher in low-rank mode
    registers its basis as a device block."""
    rng = np.random.default_rng(5)
    C = np.where(rng.random((1500, 40)) < 0.08,
                 rng.integers(1, p, (1500, 40)), 0)
    B = np.where(rng.random((40, 200)) < 0.3,
                 rng.integers(1, p, (40, 200)), 0)
    return CSR.from_dense((C @ B) % p, p)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("prime", [42013, 4294967291])
@pytest.mark.parametrize("route", ["pluq", "rank_finisher"])
def test_echelonize_U_equals_numpy_path(route, prime, device, caplog,
                                        monkeypatch):
    dev = _device(device)
    if route == "pluq":
        A, opts = _dense_square(prime), EchelonizeOptions(complete=True)
    else:
        A, opts = _tall_lowrank(prime), EchelonizeOptions(device_dense_min=0)
    pending = []
    real_add = _UBuilder.add_dense_rows_device

    def add(self, Rd, colmap, pivcols):
        pending.append(Rd.dtype)
        real_add(self, Rd, colmap, pivcols)

    monkeypatch.setattr(_UBuilder, "add_dense_rows_device", add)
    with caplog.at_level("INFO", logger="spasm_tpu_torch"):
        fact = echelonize(A, opts, device=dev)
        U = fact.U
    assert pending                        # a device block was read
    m = re.findall(r"U read: (\d+) entries from device blocks "
                   r"\(sparsified on (\S+)\), (\d+) from host segments; "
                   r"levels of 0 rows", caplog.text)
    assert m and int(m[-1][0]) > 0 and m[-1][1] == str(
        torch.empty(0, device=dev).device)
    monkeypatch.setattr(_UBuilder, "flush_device", _old_flush)
    want = echelonize(A, opts, device=dev)
    assert fact.r == want.r
    _same(fact.qinv, want.qinv)
    W = want.U
    for x, y in ((U.indptr, W.indptr), (U.indices, W.indices),
                 (U.data, W.data)):
        _same(x, y)
