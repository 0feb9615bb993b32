"""The echelonization engine: rounds of structural pivots and sparse Schur
complements, then the dense or sparse finishers.

Port of spasm_tpu/echelonize.py (the reference's spasm_echelonize.c:
473-617).  Each round finds structural pivots on the host and stops
when nothing is left (status 1), when the free columns fit the
device-resident rank finisher (status 3, no L), or when too few pivots
were found or the sampled Schur complement is dense (status 2);
otherwise the sparse Schur complement of the remaining rows
(`schur_sparse_reduced` through the reduced basis and kernel B1 without
L, `schur.schur_sparse` with L or on small inputs) becomes the next
round's matrix.  After `max_round` rounds, or on a stop, a finisher
runs on `device` (default "cuda"):
  * `finish_device_dense` (status 3): reduced basis + row-sweep RREF;
  * `finish_dense`: blocked dense Schur blocks eliminated by the chunked
    `UEliminator` and factored by the column-sweep RREF (no L) or LU
    (L / complete PLUQ, `EchelonizeOptions(L=True, complete=True)`);
  * `finish_dense_lowrank`: random combinations for tall remainders, with
    the probabilistic completion test `test_completion`;
  * `finish_gplu`: the sparse Gilbert-Peierls finisher on the host
    (native C++, or its Python twin), with the same early abort.

Every odd prime p <= 2^32 - 5 runs (the digit tiers of dense/modp.py).
With `checkpoint_file` set, the engine snapshots its state after every
round, at the finisher's entry and (throttled) after dense-finisher
blocks, and a later call on the same input resumes from the file
(checkpoint.py; the files are the JAX package's).
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import os
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from .csr import CSR, _concat_ranges
from .field import Field
from .hashing import PRNG
from .pivots import find_structural_pivots
from .profiling import annotate, phase
from .schur import (_pack_nonzero_device, estimate_density,
                    schur_dense_block,
                    schur_dense_block_device, schur_dense_randomized,
                    schur_sparse)
from .triangular import sparse_triangular_solve
from .dense.block import UEliminator, _unit_upper_inverse_log
from .dense.elim import (_size_bucket, dense_lu, dense_lu_device, dense_rank,
                         dense_rref, dense_rref_device)
from .dense.modp import dnorm64, matmul_digits
from .parallel import context as mesh_ctx

log = logging.getLogger("spasm_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


@dataclasses.dataclass
class EchelonizeOptions:
    """Mirror of struct echelonize_opts (spasm.h:84-108) with the
    reference defaults (spasm_echelonize.c:9-28), plus the device
    finisher's and the checkpoints' knobs of the JAX package."""
    enable_greedy_pivot_search: bool = True
    enable_tall_and_skinny: bool = True
    enable_dense: bool = True
    enable_GPLU: bool = True
    L: bool = False
    complete: bool = False
    min_pivot_proportion: float = 0.1
    # rounds of structural pivots + sparse Schur complement; 0: no
    # round, the finisher takes the whole matrix
    max_round: int = 3
    sparsity_threshold: float = 0.05
    tall_and_skinny_ratio: float = 5.0
    # finish_dense: rows per dense block (at least; scaled up to
    # _DENSE_ELEM_BUDGET elements); a block whose rank is below
    # low_rank_ratio * rows switches to the low-rank finisher
    dense_block_size: int = 1000
    low_rank_ratio: float = 0.5
    low_rank_start_weight: int = -1
    # BFS expansion budget for the greedy pivot search; -1 = auto
    # (32 * nnz), 0 = unlimited.
    greedy_work_budget: int = -1
    # the device finisher takes over once the free-column count fits
    # this width; 0 disables it
    device_dense_width: int = 65536
    # minimum remaining work (rows * free columns) for the device
    # finisher
    device_dense_min: int = 1 << 22
    # device memory budget (bytes) of the finisher's state: R plus the
    # finisher basis
    device_dense_mem: int = 10 << 30
    # checkpoint/resume: when set, the engine snapshots its state to
    # this file after every round and after dense-finisher blocks; a
    # call with the same input resumes from it.  Removed on completion.
    checkpoint_file: Optional[str] = None
    # minimum seconds between dense-finisher snapshots (each save repacks
    # U + S, O(nnz)); round-boundary snapshots are never throttled
    checkpoint_interval_s: float = 30.0


# L-mode dense blocks of at least this many elements (rows x free
# columns) run the device-resident Schur + LU path; smaller blocks keep
# the host sweep.
_DEVICE_LU_MIN = 1 << 16
# schur_sparse_reduced forms the Schur complement in blocks of this many
# rows
_SCHUR_BLOCK = 8192
# finish_dense's element budget per block: the device Schur block is a
# transient full-width (rows, m) array, so rows = budget // m
_DENSE_ELEM_BUDGET = 64 << 20


class _LBuilder:
    """Triplet accumulator for L (the reference's Ltmp).  Host batches
    hold numpy triplets; dense-factor parts may stay on the device
    behind thunks (add_pending) that return their nonzero triplets as
    tensors on the block's device only when L is built, so the
    factorization's wall excludes the factors' device-to-host copy.
    build() assembles the CSR where the pending blocks are (on the CPU
    when there are none) and copies it to the host once; `record` says
    where the last build ran and what it took from each side."""

    def __init__(self, prime: int):
        self.prime = prime
        self.rows: List[np.ndarray] = []
        self.cols: List[np.ndarray] = []
        self.vals: List[np.ndarray] = []
        self._pending: List = []
        self.record: Optional[dict] = None

    def add_pending(self, thunk):
        self._pending.append(thunk)

    def flush_pending(self):
        """Run the pending thunks and keep their triplets as host
        batches (what a checkpoint saves)."""
        pending, self._pending = self._pending, []
        for th in pending:
            r, c, v = (t.cpu().numpy() for t in th())
            if len(r):
                self.add_batch(r, c, v)

    def add(self, i: int, j: int, x: int):
        self.add_batch(np.asarray([i], np.int64), np.asarray([j], np.int64),
                       np.asarray([x], np.int64))

    def add_batch(self, i, j, x):
        self.rows.append(np.asarray(i, np.int64))
        self.cols.append(np.asarray(j, np.int64))
        self.vals.append(np.asarray(x, np.int64))

    def truncate(self) -> int:
        return len(self.rows)

    def rollback_filter(self, mark: int, keep_row) -> None:
        """Drop entries added after `mark` whose row fails keep_row."""
        for k in range(mark, len(self.rows)):
            sel = keep_row(self.rows[k])
            self.rows[k] = self.rows[k][sel]
            self.cols[k] = self.cols[k][sel]
            self.vals[k] = self.vals[k][sel]

    def build(self, n: int, ncols: int) -> CSR:
        """The (n, ncols) CSR of every triplet added: values summed per
        (row, col) mod p, balanced, zeros dropped, rows sorted by column
        (what COO.from_entries(...).tocsr() gives).  Each pending block
        is released once its thunk has run."""
        p, M = self.prime, max(ncols, 1)
        parts = []
        while self._pending:
            parts.append(self._pending.pop(0)())
        dev = parts[0][0].device if parts else torch.device("cpu")
        n_dev = sum(r.numel() for r, _, _ in parts)
        with phase("l_csr"):
            if self.rows:
                parts.append(tuple(
                    torch.from_numpy(np.concatenate(x)).to(dev)
                    for x in (self.rows, self.cols, self.vals)))
            n_host = sum(x.size for x in self.rows)
            empty = torch.empty(0, dtype=torch.int64, device=dev)
            keys, vals = [empty], [empty]
            while parts:
                r, c, v = parts.pop()
                v = dnorm64(v, p)
                nz = v != 0
                # row * M + col fits int64: CSR indices are int32
                keys.append(r[nz] * M + c[nz])
                vals.append(v[nz])
            key, order = torch.sort(torch.cat(keys))
            val = torch.cat(vals)[order]
            del keys, vals, order
            if key.numel():
                first = torch.ones_like(key, dtype=torch.bool)
                torch.ne(key[1:], key[:-1], out=first[1:])
                if not bool(first.all()):
                    # segment-sum the duplicates of one (row, col)
                    seg = torch.cumsum(first, 0) - 1
                    sums = torch.zeros(int(seg[-1]) + 1, dtype=torch.int64,
                                       device=dev).index_add_(0, seg, val)
                    val = dnorm64(sums, p)
                    nz = val != 0
                    key, val = key[first][nz], val[nz]
            row = torch.div(key, M, rounding_mode="floor")
            col = (key - row * M).to(torch.int32)
            val = val.to(torch.int32)
            indptr = torch.searchsorted(
                row, torch.arange(n + 1, dtype=torch.int64, device=dev))
            nnz = int(indptr[-1])       # waits for the device's work
        with phase("l_copy"):
            L = CSR(n, ncols, Field(p), indptr.cpu().numpy(),
                    col.cpu().numpy(), val.cpu().numpy())
        self.record = {"device": str(dev), "device_entries": n_dev,
                       "host_entries": n_host}
        log.info("[echelonize] L's CSR built on %s: %d entries from device "
                 "blocks, %d from host batches, %d nonzeros",
                 dev, n_dev, n_host, nnz)
        return L


def _nonzero_triplets(X: torch.Tensor, rows, row_ids, col_ids):
    """(row_ids[i], col_ids[j], X[i, j]) for the nonzeros of X's rows
    `rows` (sorted; every row when None), row-major as np.nonzero gives
    them, as tensors on X's device."""
    with phase("l_sparsify"):
        dev = X.device
        if rows is not None:
            X = X[torch.as_tensor(rows, device=dev)]
            row_ids = np.asarray(row_ids)[rows]
        i, j = torch.nonzero(X).unbind(1)
        return (torch.as_tensor(np.asarray(row_ids, np.int64), device=dev)[i],
                torch.as_tensor(np.asarray(col_ids, np.int64), device=dev)[j],
                X[i, j])


class _UBuilder:
    """Incremental U accumulator: rows with unitary pivots first.

    Rows live in segments (offs, cols, vals, pivcols, levels) of flat
    arrays; rows may also arrive as device-resident dense blocks, which
    stay where they are until a read (the rank path never reads them):
    flush_device sparsifies them with torch on their own device and
    copies their CSR to the host once.  Segment levels are topological
    levels: equal-level rows never contain each other's pivot columns;
    a segment without levels is mutually independent.  A row only
    references pivot columns of later rows.  `record` says, after each
    flush and read, where the device blocks were sparsified, how many
    entries came from them and from host segments, and how many rows'
    levels the read computed (flat_store's callers only).
    """

    def __init__(self, m: int, prime: int):
        self.m = m
        self.prime = prime
        self.field = Field(prime)
        self.qinv = np.full(m, -1, dtype=np.int64)
        self._segs: List[tuple] = []
        # deferred device blocks: (Rd, colmap, pivcols_global, base_row)
        self._pending: List[tuple] = []
        self._n = 0
        self._dev = "cpu"              # where the last device block was
        self._dev_entries = 0          # entries of the flushed blocks
        self.record: Optional[dict] = None

    @property
    def n(self) -> int:
        return self._n

    def add_row(self, pivcol: int, cols: np.ndarray, vals: np.ndarray):
        """cols/vals: a full row with value 1 at pivcol, stored pivot
        first.  Returns the stored (cols, vals) pair."""
        sel = cols != pivcol
        c = np.concatenate(([pivcol], cols[sel])).astype(np.int32)
        v = np.concatenate(([1], vals[sel])).astype(np.int32)
        self.add_rows_bulk(np.asarray([pivcol], np.int64),
                           np.asarray([0, c.size], np.int64), c, v)
        return c, v

    def add_rows_bulk(self, pivcols: np.ndarray, offs: np.ndarray,
                      cols: np.ndarray, vals: np.ndarray, levels=None):
        """Bulk append of pivot-first rows (value 1 at pivcols[k])."""
        npiv = len(pivcols)
        if npiv == 0:
            return
        self.flush_device()
        self._segs.append((np.asarray(offs, np.int64),
                           np.asarray(cols, np.int32),
                           np.asarray(vals, np.int32),
                           np.asarray(pivcols, np.int64),
                           None if levels is None
                           else np.asarray(levels, np.int64)))
        self.qinv[np.asarray(pivcols, np.int64)] = \
            self._n + np.arange(npiv)
        self._n += npiv

    def add_dense_rows_device(self, Rd: torch.Tensor, colmap: np.ndarray,
                              pivcols_global: np.ndarray):
        """Register device RREF rows without copying them to the host.
        Rd: (rank, w) device block (row k has value 1 at the column
        mapping to pivcols_global[k]); colmap: (w,) global column ids."""
        pivcols = np.asarray(pivcols_global, np.int64)
        self.qinv[pivcols] = self._n + np.arange(len(pivcols))
        self._pending.append((Rd, np.asarray(colmap, np.int64),
                              pivcols, self._n))
        self._n += len(pivcols)

    def flush_device(self):
        """Materialize pending device blocks into host sparse segments:
        their nonzeros, each row's pivot first, found with torch where
        the blocks are; one copy of the CSR to the host."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        with phase("u_sparsify"):
            parts = [part for Rd, colmap, pivcols, _ in pending
                     for part in _pivot_first_csr(Rd, colmap, pivcols)]
            counts, cols, vals = (torch.cat(x) for x in zip(*parts))
            del parts
            nnz = int(counts.sum())        # waits for the device's work
        with phase("u_copy"):
            counts, cols, vals = (t.cpu().numpy()
                                  for t in (counts, cols, vals))
            vals = vals.astype(np.int32, copy=False)
            k0 = e0 = 0
            for Rd, _, pivcols, _ in pending:
                k1 = k0 + Rd.shape[0]
                offs = np.zeros(k1 - k0 + 1, np.int64)
                np.cumsum(counts[k0:k1], out=offs[1:])
                e1 = e0 + int(offs[-1])
                self._segs.append((offs, cols[e0:e1], vals[e0:e1], pivcols,
                                   None))
                k0, e0 = k1, e1
        self._dev = str(pending[-1][0].device)
        self._dev_entries += nnz
        self._note(0)

    def _note(self, level_rows: int):
        nnz = sum(int(s[0][-1]) for s in self._segs)
        self.record = {"device": self._dev,
                       "device_entries": self._dev_entries,
                       "host_entries": nnz - self._dev_entries,
                       "level_rows": level_rows}

    def _flat(self, groups: bool):
        """All rows as flat arrays (offs, cols, vals, pivcols, groups);
        groups (the segments' levels, offset per segment) only when
        asked for, else None."""
        self.flush_device()
        if not self._segs:
            self._note(0)
            z = np.zeros(1, np.int64)
            return (z, np.empty(0, np.int32), np.empty(0, np.int32),
                    np.empty(0, np.int64),
                    np.empty(0, np.int64) if groups else None)
        offs_all = [np.zeros(1, np.int64)]
        cols_all, vals_all, piv_all, grp_all = [], [], [], []
        base = 0
        gid = 0
        level_rows = 0
        for offs, cols, vals, pivcols, levels in self._segs:
            offs_all.append(offs[1:] + base)
            base += offs[-1]
            cols_all.append(cols[:offs[-1]])
            vals_all.append(vals[:offs[-1]])
            piv_all.append(pivcols)
            if not groups:
                continue
            if levels is None:
                level_rows += len(pivcols)
                with phase("u_levels"):
                    levels = _intra_levels(offs, cols, pivcols)
            grp_all.append(gid + levels)
            gid += int(levels.max(initial=0)) + 1
        self._note(level_rows)
        log.info("[echelonize] U read: %d entries from device blocks "
                 "(sparsified on %s), %d from host segments; levels of %d "
                 "rows", self.record["device_entries"], self._dev,
                 self.record["host_entries"], level_rows)
        with phase("u_concat"):
            return (np.concatenate(offs_all), np.concatenate(cols_all),
                    np.concatenate(vals_all), np.concatenate(piv_all),
                    np.concatenate(grp_all) if groups else None)

    def flat_store(self):
        """All rows as one flat store for the reduced-basis build.
        Returns (offs, cols, vals, pivcols, groups): equal-group rows are
        mutually independent and rows only reference greater groups."""
        return self._flat(True)

    def snapshot_csr(self) -> CSR:
        """U as a host CSR, rows in order; no levels computed."""
        offs, cols, vals, _, _ = self._flat(False)
        return CSR(self._n, self.m, self.field, offs, cols, vals)

    def nnz(self) -> int:
        if self._pending:
            return -1          # unknown without forcing a copy
        return int(sum(int(s[0][-1]) for s in self._segs))


# flush_device sparsifies a device block in row chunks of at most this
# many elements: torch.nonzero and the index passes over its output take
# about 50 bytes a nonzero on the block's device
_U_CHUNK_ELEMS = 1 << 25


def _pivot_first_csr(Rd: torch.Tensor, colmap: np.ndarray,
                     pivcols: np.ndarray) -> list:
    """The nonzeros of the dense block Rd (K, w) of U rows as CSR parts
    on Rd's device, one (counts, cols, vals) a chunk of rows: counts
    int64 per row, cols int32 global columns (colmap[c]), vals in Rd's
    dtype (int32 if wider).  A row's entries keep their local-column
    order, except its pivot entry (local column of pivcols[k]), which
    moves to the front: the order np.lexsort((~first, row)) gives
    np.nonzero's entries."""
    dev = Rd.device
    K, w = Rd.shape
    order = np.argsort(colmap, kind="stable")
    ppos = torch.as_tensor(order[np.searchsorted(colmap, pivcols,
                                                 sorter=order)], device=dev)
    cmap = torch.as_tensor(colmap.astype(np.int32), device=dev)
    vdtype = Rd.dtype if Rd.element_size() <= 4 else torch.int32
    parts = []
    h = max(1, _U_CHUNK_ELEMS // max(w, 1))
    for r0 in range(0, max(K, 1), h):      # one chunk of an empty block
        X = Rd[r0:r0 + h]
        r, c = torch.nonzero(X).unbind(1)
        cnt = torch.bincount(r, minlength=X.shape[0])
        pr = ppos[r0:r0 + h][r]
        piv = c == pr
        rp = r[piv]
        has = torch.zeros(X.shape[0], dtype=torch.bool, device=dev)
        has[rp] = True
        # entries left of their row's pivot move one slot right, the
        # pivot to its row's first slot (a shift, not a swap)
        dest = torch.arange(r.numel(), device=dev)
        dest += (c < pr) & has[r]
        dest[piv] = (torch.cumsum(cnt, 0) - cnt)[rp]
        cc = torch.empty(r.numel(), dtype=torch.int32, device=dev)
        cc[dest] = cmap[c]
        vv = torch.empty(r.numel(), dtype=vdtype, device=dev)
        vv[dest] = X[r, c].to(vdtype)
        parts.append((cnt, cc, vv))
    return parts


def _intra_levels(offs: np.ndarray, cols: np.ndarray,
                  pivcols: np.ndarray) -> np.ndarray:
    """Forward topological levels of an upper-triangular row set: row
    k's entries on later rows' pivot columns force those rows to a level
    above level(k).  Zeros fast when no row references another."""
    n = len(pivcols)
    lev = np.zeros(n, np.int64)
    if n <= 1:
        return lev
    pivcols = np.asarray(pivcols, np.int64)
    order = np.argsort(pivcols, kind="stable")
    sorted_piv = pivcols[order]
    nnz = int(offs[-1])
    pos = np.searchsorted(sorted_piv, cols[:nnz])
    pos = np.minimum(pos, n - 1)
    hit = sorted_piv[pos] == cols[:nnz]
    ref = np.where(hit, order[pos], -1)
    rowid = np.repeat(np.arange(n), np.diff(offs))
    intra = hit & (ref != rowid)
    if not np.any(intra):
        return lev
    src = rowid[intra]
    dst = ref[intra]
    o = np.argsort(src, kind="stable")
    s2, d2 = src[o], dst[o]
    bounds = np.concatenate(
        ([0], np.nonzero(np.diff(s2))[0] + 1, [len(s2)]))
    for i in range(len(bounds) - 1):              # ascending source rows
        k = s2[bounds[i]]
        t = d2[bounds[i]:bounds[i + 1]]
        np.maximum.at(lev, t, lev[k] + 1)
    return lev


class _GrowingCSR:
    """Append-only CSR view with capacity doubling: the GPLU finisher
    solves each chunk against the current U, and repacking U per chunk
    would be quadratic over the run.  Rows append in amortized O(row
    nnz); the views are trimmed arrays the native solver takes."""

    def __init__(self, base: CSR):
        self.n = base.n
        self.m = base.m
        self.prime = base.prime
        self.field = base.field
        nnz = base.nnz
        self._indptr = np.zeros(max(2 * base.n + 8, 64) + 1, np.int64)
        self._indptr[:base.n + 1] = base.indptr[:base.n + 1]
        cap = max(2 * nnz + 64, 256)
        self._indices = np.empty(cap, np.int32)
        self._indices[:nnz] = base.indices[:nnz]
        self._data = np.empty(cap, np.int32)
        self._data[:nnz] = base.data[:nnz]
        self._nnz = nnz

    @property
    def indptr(self) -> np.ndarray:
        return self._indptr[:self.n + 1]

    @property
    def indices(self) -> np.ndarray:
        return self._indices[:self._nnz]

    @property
    def data(self) -> np.ndarray:
        return self._data[:self._nnz]

    def append_row(self, cols: np.ndarray, vals: np.ndarray):
        k = len(cols)
        if self._nnz + k > self._indices.size:
            cap = max(2 * self._indices.size, self._nnz + k)
            for name in ("_indices", "_data"):
                new = np.empty(cap, np.int32)
                new[:self._nnz] = getattr(self, name)[:self._nnz]
                setattr(self, name, new)
        if self.n + 2 > self._indptr.size:
            new = np.zeros(2 * self._indptr.size, np.int64)
            new[:self.n + 1] = self._indptr[:self.n + 1]
            self._indptr = new
        self._indices[self._nnz:self._nnz + k] = cols
        self._data[self._nnz:self._nnz + k] = vals
        self._nnz += k
        self.n += 1
        self._indptr[self.n] = self._nnz


class LU:
    """Result object (the reference's struct spasm_lu, spasm.h:64-72).
    U and L are materialized from the device on first access, so callers
    that only need the rank never pay the factor-sized device-to-host
    copies.  With L: A == L @ U when `complete`, else on the pivotal rows
    p."""

    def __init__(self, r: int, U: Optional[CSR] = None,
                 qinv: Optional[np.ndarray] = None,
                 L: Optional[CSR] = None, p: Optional[np.ndarray] = None,
                 complete: bool = False, u_thunk=None, l_thunk=None):
        self.r = r
        self._U = U
        self._u_thunk = u_thunk
        self.qinv = qinv        # (m,) pivot of col j on row qinv[j] of U
        self._L = L
        self._l_thunk = l_thunk
        self.p = p              # (r,) original row of pivot k
        self.complete = complete
        # one dict per round this call ran (a resumed call starts at the
        # file's round): structural pivots, sampled Schur density, nnz
        # of the sparse Schur complement (the keys a round reached)
        self.rounds: List[dict] = []

    @property
    def U(self) -> CSR:
        if self._U is None and self._u_thunk is not None:
            with phase("factors_u"):
                self._U = self._u_thunk()
            self._u_thunk = None
        return self._U

    @property
    def L(self) -> Optional[CSR]:
        if self._L is None and self._l_thunk is not None:
            with phase("factors_l"):
                self._L = self._l_thunk()
            self._l_thunk = None
        return self._L


class _Engine:
    def __init__(self, A: CSR, opts: EchelonizeOptions, device):
        self.A0 = A
        self.opts = opts
        self.device = torch.device(device)
        self.m = A.m
        self.prime = A.prime
        self.field = A.field
        self.U = _UBuilder(A.m, A.prime)
        self.L = _LBuilder(A.prime) if opts.L else None
        self.Lp: List[int] = []          # original pivot row per U row
        # staged lazily: the rank path through finish_device_dense never
        # composes its chunks
        self.elim = UEliminator(A.m, A.prime, self.device)
        self._fp: Optional[bytes] = None
        self.rounds: List[dict] = []

    @property
    def fingerprint(self) -> bytes:
        """SHA-256 of the input matrix (binds randomized draws to it)."""
        if self._fp is None:
            self._fp = ckpt.matrix_fingerprint(self.A0)
        return self._fp

    def _push_u_row(self, pivcol: int, cols, vals):
        cols_p, vals_p = self.U.add_row(pivcol, np.asarray(cols),
                                        np.asarray(vals))
        self.elim.append_rows(
            [(cols_p.astype(np.int64), vals_p, int(pivcol))], flush=False)

    def extract_structural(self, S: CSR, p_in=None) -> tuple:
        """Find structural pivots in S and push them to U (and L).
        Returns (npiv, p) with the pivotal rows of S first in topological
        order.  (reference: spasm_pivots_extract_structural,
        spasm_pivots.c:369-448)"""
        t0 = time.time()
        with phase("pivots"):
            npiv, p, pinv, _, levels = find_structural_pivots(
                S, self.opts.enable_greedy_pivot_search,
                self.opts.greedy_work_budget)
        F = self.field
        if npiv:
            rows = p[:npiv]
            starts = S.indptr[rows]
            lens = (S.indptr[rows + 1] - starts).astype(np.int64)
            gather = _concat_ranges(starts, lens)
            cols_flat = S.indices[gather].astype(np.int64)
            vals_flat = S.data[gather].astype(np.int64)
            rowrep = np.repeat(np.arange(npiv), lens)
            pivcols = pinv[rows]
            on_piv = cols_flat == pivcols[rowrep]
            pv = np.zeros(npiv, np.int64)
            pv[rowrep[on_piv]] = vals_flat[on_piv]
            alpha = F.inverse_array(pv).astype(np.int64)
            scaled = F.narray(vals_flat * alpha[rowrep]).astype(np.int32)
            offs = np.concatenate(([0], np.cumsum(lens)))
            iorigs = (np.asarray(p_in, np.int64)[rows]
                      if p_in is not None else rows)
            if self.L is not None:
                self.L.add_batch(iorigs, self.U.n + np.arange(npiv), pv)
            self.Lp.extend(int(v) for v in iorigs)
            # pivot-first: swap each row's pivot entry into its first slot
            piv_pos = np.flatnonzero(on_piv)
            first = offs[:-1]
            cols2 = cols_flat.copy()
            vals2 = scaled.copy()
            cols2[piv_pos] = cols_flat[first]
            vals2[piv_pos] = scaled[first]
            cols2[first] = pivcols
            vals2[first] = 1
            self.U.add_rows_bulk(pivcols, offs, cols2.astype(np.int32),
                                 vals2, levels=levels)
            self.elim.append_segment(offs, cols2, vals2, pivcols, levels)
        log.info("[pivots] %d structural pivots found [%.2fs]",
                 npiv, time.time() - t0)
        return npiv, p

    def update_after_rref(self, R: np.ndarray, pivcols: np.ndarray,
                          q: np.ndarray):
        """Push dense RREF rows (columns compacted by q) into U.
        (reference: update_U_after_rref, spasm_echelonize.c:192-223)"""
        nz_r, nz_c = np.nonzero(R)
        counts = np.bincount(nz_r, minlength=R.shape[0])
        offs = np.concatenate(([0], np.cumsum(counts)))
        vals_flat = R[nz_r, nz_c]
        cols_flat = q[nz_c]
        for k in range(len(pivcols)):
            sl = slice(offs[k], offs[k + 1])
            self._push_u_row(int(q[pivcols[k]]), cols_flat[sl],
                             vals_flat[sl])

    def update_after_lu(self, rank: int, prows, pivcols, Ld, Urows,
                        q: np.ndarray, p_out: np.ndarray, lmark: int):
        """Push a host dense LU into U and L.
        (reference: update_fact_after_LU, spasm_echelonize.c:228-313)"""
        if not self.opts.complete:
            pivotal = np.asarray(sorted(set(int(p_out[r]) for r in prows))
                                 or [-1], np.int64)
            self.L.rollback_filter(lmark,
                                   lambda rows: np.isin(rows, pivotal))
        ubase = self.U.n
        rows_iter = range(Ld.shape[0]) if self.opts.complete else \
            [int(r) for r in prows]
        for i in rows_iter:
            nz = np.nonzero(Ld[i])[0]
            if nz.size:
                self.L.add_batch(np.full(nz.size, int(p_out[i]), np.int64),
                                 ubase + nz, Ld[i][nz])
        for k in range(rank):
            self.Lp.append(int(p_out[prows[k]]))
            nz = np.nonzero(Urows[k])[0]
            self._push_u_row(int(q[pivcols[k]]), q[nz], Urows[k][nz])

    def _dense_lu_block_device(self, S: CSR, rows: np.ndarray, p_in) -> int:
        """Device-resident L-mode dense block: Schur elimination,
        column-pivoted LU and the factor merge run on the device, and the
        factors stay there.  L gets thunks, U a pending device segment,
        and the eliminator a device-composed chunk V = (I + W)^-1 Ud with
        its winv, so later blocks park per-U-row coefficients.  No
        factor-sized copy to the host happens unless the caller reads L
        or U.  (reference: update_fact_after_LU,
        spasm_echelonize.c:228-313)  Returns the block's rank."""
        dev = self.device
        Xq, q, p_out, (Cd, piv_cols) = schur_dense_block_device(
            S, rows, p_in, self.U.qinv, self.elim, want_L=True)
        prows, pivcols, Ld, Ud = dense_lu_device(Xq, self.prime)
        rank = int(pivcols.size)
        B = len(rows)
        ucols = self.U.qinv[piv_cols].copy()
        # L's rows of this block: all of them, or the pivotal ones
        lrows = None if self.opts.complete else np.sort(prows)

        # part 1: the coefficients against the prior pivots
        self.L.add_pending(functools.partial(
            _nonzero_triplets, Cd[:B, :piv_cols.size], lrows, p_out, ucols))
        if rank:
            # part 2: the dense factor's multipliers
            ubase = self.U.n
            self.L.add_pending(functools.partial(
                _nonzero_triplets, Ld[:B], lrows, p_out,
                np.arange(ubase, ubase + rank, dtype=np.int64)))
            colmap = np.full(Ud.shape[1], self.m, np.int64)
            colmap[:q.size] = q
            self.U.add_dense_rows_device(Ud, colmap, q[pivcols])
            with phase("compose_chunk"):
                W = torch.triu(Ud[:, torch.as_tensor(pivcols, device=dev)],
                               1)
                Winv = _unit_upper_inverse_log(W, self.prime)
                V = matmul_digits(Winv, Ud, self.prime)
            self.elim.flush()
            self.elim._register_device_chunk(V, colmap, pivcols, winv=Winv)
            self.Lp.extend(p_out[prows].tolist())
        return rank

    def schur_sparse_reduced(self, S: CSR, rows_p: np.ndarray, n: int,
                             p_in) -> tuple:
        """Sparse Schur complement through the reduced basis (no L): the
        rows' residues form in the compacted free-column domain against
        R (built by kernel B1), in blocks of _SCHUR_BLOCK rows, and
        their nonzeros are packed back to CSR.  Block b's forming runs
        on the device while the host packs block b - 1 and prepares
        block b + 1.  Returns (S2, p_out): row k of S2 is original row
        p_out[k].  (reference: spasm_schur, spasm_schur.c:61-193)"""
        from .dense.reduced import ReducedBasis
        qfree = np.nonzero(self.U.qinv < 0)[0]
        rb = ReducedBasis(self.m, self.prime, qfree, self.U.n, self.device)
        with phase("reduced_basis"):
            rb.build(*self.U.flat_store())
        rb.set_entries(S.indices, S.data, S.nnz)
        counts = np.zeros(n, np.int64)
        cols, vals = [], []
        p_out = (np.asarray(p_in, np.int64)[rows_p[:n]]
                 if p_in is not None else np.asarray(rows_p[:n], np.int64))

        def drain(b0, packed):
            r, c, v = packed
            counts[b0:b0 + _SCHUR_BLOCK] += np.bincount(
                r, minlength=min(_SCHUR_BLOCK, n - b0))
            cols.append(qfree[c].astype(np.int32))
            vals.append(v)

        pending = None              # (b0, formed block, rows) of block b - 1
        for b0 in range(0, n, _SCHUR_BLOCK):
            idx = rows_p[b0:b0 + _SCHUR_BLOCK]
            eidx, coeff = rb.flat_rows(S.indptr, idx)
            # block b - 1's entries cross to the host before block b is
            # queued behind them, then drain while block b forms
            packed = (_pack_nonzero_device(pending[1], pending[2], rb.nq)
                      if pending is not None else None)
            Xd = rb.form_block(eidx, coeff)
            if packed is not None:
                drain(pending[0], packed)
            pending = (b0, Xd, len(idx))
        if pending is not None:
            drain(pending[0], _pack_nonzero_device(pending[1], pending[2],
                                                   rb.nq))
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        S2 = CSR(n, self.m, self.field, indptr,
                 np.concatenate(cols) if cols else np.empty(0, np.int32),
                 np.concatenate(vals) if vals else np.empty(0, np.int32))
        return S2, p_out

    def test_completion(self, S: CSR, p: np.ndarray, n: int) -> bool:
        """Probabilistic early-abort test with ceil(128 / log2 p) random
        full combinations (spasm_echelonize.c:30-51)."""
        if n == 0 or S.nnz == 0:
            return True
        Sn = int(np.ceil(128 / np.log2(self.prime)))
        if self.elim.nrows > 0:
            # on the device: only the (m,) pivot map returns to the host
            Xd, _ = schur_dense_randomized(S, p, n, None, self.U.qinv, Sn,
                                           0, eliminator=self.elim,
                                           return_device=True)
            _, pivcols = dense_rref_device(Xd, self.prime)
            return len(pivcols) == 0
        X, _ = schur_dense_randomized(S, p, n, self.U.snapshot_csr(),
                                      self.U.qinv, Sn, 0,
                                      eliminator=self.elim)
        return dense_rank(X, self.prime, device=self.device) == 0

    @annotate("finish_lowrank")
    def finish_dense_lowrank(self, S: CSR, p: np.ndarray, n: int):
        """Randomized tall-and-skinny finisher
        (echelonize_dense_lowrank, spasm_echelonize.c:315-379)."""
        opts = self.opts
        rank_ub = min(n, self.m - self.U.n)
        w = int(np.ceil(-np.log(0.01) * n / max(rank_ub, 1))) \
            if opts.low_rank_start_weight < 0 else opts.low_rank_start_weight
        t0 = time.time()
        old_un = self.U.n
        seed = 0
        rounds = 0
        use_device = self.elim.nrows > 0
        while True:
            Sn = min(rank_ub, opts.dense_block_size)
            if Sn <= 0:
                break
            if use_device:
                Xd, q = schur_dense_randomized(
                    S, p, n, None, self.U.qinv, Sn, w, eliminator=self.elim,
                    seed_base=seed, return_device=True)
                seed += Sn
                Rd, pivcols = dense_rref_device(Xd, self.prime)
                rr = len(pivcols)
                if rr:
                    self.elim.append_device_chunk(Rd, q, pivcols)
                    self.U.add_dense_rows_device(Rd, q, q[pivcols])
            else:
                X, q = schur_dense_randomized(
                    S, p, n, self.U.snapshot_csr(), self.U.qinv, Sn, w,
                    eliminator=self.elim, seed_base=seed)
                seed += Sn
                R, pivcols = dense_rref(X, self.prime, device=self.device)
                rr = len(pivcols)
                if rr:
                    self.update_after_rref(R, pivcols, q)
            if rr == 0:
                if self.test_completion(S, p, n):
                    break
                log.info("[lowrank] failed termination test; full combos")
                w = 0
                continue
            if rr < 0.9 * Sn:
                w = max(2 * w, 2)
            use_device = self.elim.nrows > 0
            rank_ub -= rr
            rounds += 1
            log.info("[lowrank] round %d: %d new pivots", rounds, rr)
        log.info("[lowrank] done in %.1fs, %d new pivots",
                 time.time() - t0, self.U.n - old_un)

    @annotate("finish_dense")
    def finish_dense(self, S: CSR, p: np.ndarray, n: int, p_in,
                     checkpoint_cb=None, processed: int = 0):
        """Blocked dense finisher (echelonize_dense,
        spasm_echelonize.c:385-463): blocks of rows become dense Schur
        blocks on the device, then RREF (no L) or LU (L mode) there;
        L-mode blocks under _DEVICE_LU_MIN elements take the host sweep.
        checkpoint_cb(processed) runs after each block; a resume passes
        the saved `processed` and starts at that row."""
        opts = self.opts
        dev = self.device
        t0 = time.time()
        old_un = self.U.n
        lowrank_mode = False
        while True:
            # the device Schur block is a transient full-width (B, m)
            # array: the budget divides by m, not by the free columns
            auto_bs = max(opts.dense_block_size,
                          _DENSE_ELEM_BUDGET // max(self.m, 1))
            Sn = min(auto_bs, n - processed)
            if Sn <= 0:
                break
            rows = p[processed:processed + Sn]
            if opts.L and Sn * max(self.m - self.U.n, 1) >= _DEVICE_LU_MIN:
                rr = self._dense_lu_block_device(S, rows, p_in)
            elif opts.L:
                lmark = self.L.truncate()
                X, q, p_out = schur_dense_block(
                    S, rows, p_in, self.U.qinv, self.elim, self.L,
                    U_csr=self.U.snapshot_csr())
                rank, prows, pivcols, Ld, Urows = dense_lu(
                    X, self.prime, device=dev)
                self.update_after_lu(rank, prows, pivcols, Ld, Urows, q,
                                     p_out, lmark)
                rr = rank
            else:
                # on the device: eliminate -> RREF -> register the pivot
                # rows as a device chunk, no matrix-sized copy to the host
                Xd, q, p_out = schur_dense_block_device(
                    S, rows, p_in, self.U.qinv, self.elim)
                Rd, pivcols = dense_rref_device(Xd, self.prime)
                rr = len(pivcols)
                if rr:
                    self.elim.append_device_chunk(Rd, q, pivcols)
                    self.U.add_dense_rows_device(Rd, q, q[pivcols])
            processed += Sn
            log.info("[dense] block of %d rows: %d new pivots", Sn, rr)
            if checkpoint_cb is not None:
                # the snapshot does not record this block's low-rank test
                # below: a resume at `processed` goes on with full blocks
                # even where this block would have switched to low-rank
                # mode (as in the JAX package, whose files these are)
                checkpoint_cb(processed)
            if opts.enable_tall_and_skinny and rr < opts.low_rank_ratio * Sn:
                lowrank_mode = True
                break
        if lowrank_mode and n - processed > 0:
            log.info("[dense] too few pivots; switching to low-rank mode")
            self.finish_dense_lowrank(S, p[processed:], n - processed)
        else:
            log.info("[dense] done in %.1fs, %d new pivots",
                     time.time() - t0, self.U.n - old_un)

    # -- device-resident finisher ------------------------------------------

    def _completion_device(self, dcsr, cand_rows: np.ndarray,
                           vals: np.ndarray, rb, basis) -> bool:
        """Probabilistic completion test on the device: random full
        combinations of the candidate rows, eliminated against the whole
        basis; complete iff every residue is zero.
        (spasm_echelonize.c:30-51, the combination formed by an SpMV.)
        vals: (Sn, len(cand_rows)) balanced coefficients from the
        reference PRNG."""
        Sn = vals.shape[0]
        XT = np.zeros((Sn, dcsr.n), np.int32)
        XT[:, cand_rows] = vals
        Y = dcsr.spmv(torch.as_tensor(XT, device=self.device))
        Yq = rb.eliminate_full_width(Y)         # (Sn, M) compact residue
        Yq = basis.apply(Yq)
        if isinstance(Yq, mesh_ctx.Sharded):    # per shard, then the sum
            return mesh_ctx.sum_count(
                [torch.count_nonzero(t) for t in Yq.shards], site=4) == 0
        return not bool(torch.any(Yq != 0))

    @annotate("finish_device")
    def finish_device_dense(self, S: CSR, p: np.ndarray, n: int):
        """Device-resident dense finisher (the JAX package's TPU-first
        replacement of echelonize_dense and echelonize_dense_lowrank,
        spasm_echelonize.c:315-463): build the reduced basis R once,
        then per round form a block of rows (or of random sparse
        combinations when the residual is tall) against R, eliminate it
        against the growing basis, row-sweep it to RREF and append the
        new pivot rows.  Only the (B,) pivot-column map returns to the
        host per round."""
        from .dense.reduced import ReducedBasis
        from .dense.rowrref import CompactBasis, rref_rows_device

        opts = self.opts
        m = self.m
        prime = self.prime
        dev = self.device
        t0 = time.time()
        old_un = self.U.n

        qfree = np.nonzero(self.U.qinv < 0)[0]
        nq = qfree.size
        rb = ReducedBasis(m, prime, qfree, self.U.n, dev)
        with phase("flat_store"):
            offs_u, cols_u, vals_u, piv_u, grp_u = self.U.flat_store()
        with phase("reduced_basis"):
            rb.build(offs_u, cols_u, vals_u, piv_u, grp_u)
        rb.set_entries(S.indices, S.data, S.nnz)
        M = rb.M
        q_ext = np.full(M, m, np.int64)      # slot -> global column
        q_ext[:nq] = qfree

        rank_ub = min(n, nq)
        aspect = n / max(nq, 1)
        lowrank = (opts.enable_tall_and_skinny
                   and aspect > opts.tall_and_skinny_ratio)
        B = min(_size_bucket(rank_ub + 64, 64), 4096)
        # residual cleanup rounds run at a small fixed height
        B_SMALL = min(1024, B)
        # sparse combination weight: the reference's coupon-collector
        # start (-log(0.01) * n / rank) capped low; shortfalls are caught
        # by the completion test + weight doubling
        w = int(np.ceil(-np.log(0.01) * n / max(rank_ub, 1))) \
            if opts.low_rank_start_weight < 0 else \
            max(opts.low_rank_start_weight, 1)
        if opts.low_rank_start_weight < 0:
            w = min(w, 8)
        # form_block's scatter accumulates up to w colliding balanced
        # entries in int32 in the d == 2 tier: w * (p//2) < 2^31 (int64
        # above it; the cap stays there too, so the draws are the JAX
        # package's)
        w_cap = max(1, ((1 << 31) - 1) // max(prime // 2, 1))
        w = min(w, w_cap)
        # deterministic draws bound to the input matrix through the
        # reference PRNG: seq 0 feeds the combinations, seq 1 the
        # completion-test coefficients
        gen = PRNG(prime, self.fingerprint)
        Sn_test = int(np.ceil(128 / np.log2(prime)))
        comp_pool: dict = {}

        def _pregen():                       # overlaps device work
            g2 = PRNG(prime, self.fingerprint, seq=1)
            comp_pool["vals"] = g2.zzp_array(Sn_test * n).reshape(
                Sn_test, n)

        comp_thread = threading.Thread(target=_pregen, daemon=True)
        comp_thread.start()

        def comp_vals(pos: np.ndarray) -> np.ndarray:
            """(Sn, len(pos)) coefficients for candidates p[pos]."""
            comp_thread.join()
            return comp_pool["vals"][:, pos]

        basis = CompactBasis(M, prime, rank_ub + 4096, dev)
        dcsr = None
        processed = 0
        rounds = 0
        log.info("[finish/device] %s mode: %d rows x %d free cols, "
                 "block %d, basis %d", "lowrank" if lowrank else "rows",
                 n, nq, B, self.U.n)

        @annotate("form_block")
        def make_block(nrows, rows_from):
            """Host prep + device dispatch of one eliminated block."""
            if lowrank:
                sel = p[gen.uniform_array(nrows * w, n)
                        .reshape(nrows, w)]
                coeffs = gen.zzp_array(nrows * w).reshape(
                    nrows, w).astype(np.int32)
                coeffs[:, 0] = 1
                eidx, coeff = rb.flat_rows(S.indptr, sel, coeffs)
            else:
                eidx, coeff = rb.flat_rows(
                    S.indptr, p[rows_from:rows_from + nrows])
            return rb.form_block(
                eidx, coeff, Bp=B_SMALL if nrows <= B_SMALL else B)

        @annotate("completion")
        def completion(cand: np.ndarray) -> bool:
            nonlocal dcsr
            if dcsr is None:
                from .device_csr import DeviceCSR
                dcsr = DeviceCSR(S, device=dev)
            return self._completion_device(dcsr, p[cand], comp_vals(cand),
                                           rb, basis)

        prefetched = None           # (N, formed block)
        while rank_ub > 0:
            if prefetched is not None:
                N, Xq = prefetched
                prefetched = None
            else:
                if lowrank:
                    N = min(B, rank_ub + 64)
                else:
                    N = min(B, n - processed)
                    if N <= 0:
                        break
                    processed += N
                Xq = make_block(N, processed - N)
            with phase("basis_apply"):
                Xq = basis.apply(Xq)
            with phase("rref_rows"):
                Xq, pivd = rref_rows_device(Xq, prime, nb=512)
            # overlap the next block's host prep + forming with the
            # in-flight RREF: forming reads only R, not the basis
            if lowrank and rank_ub - N > 0:
                N2 = min(B, rank_ub - N + 64)   # full-yield assumption
                prefetched = (N2, make_block(N2, 0))
            elif not lowrank and processed < n:
                N2 = min(B, n - processed)
                prefetched = (N2, make_block(N2, processed))
                processed += N2
            with phase("pivcol_wait"):
                pivcol = pivd.cpu().numpy()
            hit = np.nonzero(pivcol >= 0)[0]
            rr = hit.size
            if rr:
                # pad the new chunk to a row bucket (dead rows pivot at
                # the dead column, their rows zero)
                Kp = _size_bucket(rr, 64)
                hit_p = np.zeros(Kp, np.int64)
                hit_p[:rr] = hit

                def pick(t):
                    r = t[torch.as_tensor(hit_p, device=t.device)]
                    r[rr:] = 0
                    return r
                with phase("basis_add"):
                    Rd = mesh_ctx.smap(pick, Xq)
                    jpos = np.full(Kp, M - 1, np.int64)
                    jpos[:rr] = pivcol[hit]
                    basis.add(Rd, jpos)
                rank_ub -= rr
            rounds += 1
            log.info("[finish/device] round %d: %d rows -> %d new pivots",
                     rounds, N, rr)
            if lowrank and rank_ub > 0 and rr < 0.9 * N:
                # a weak round doubles the weight and keeps going; the
                # completion test runs once combinations stop yielding
                if rr >= 0.02 * N:
                    log.info("[finish/device] weak round; weight "
                             "%d -> %d", w, 2 * w)
                    w = min(2 * w, max(n, 1), w_cap)
                    prefetched = None    # formed with the stale weight
                    continue
                if completion(np.arange(n)):
                    break
                log.info("[finish/device] completion test failed; "
                         "weight %d -> %d", w, 2 * w)
                w = min(2 * w, max(n, 1), w_cap)
                prefetched = None        # formed with the stale weight
            elif not lowrank and rr == 0 and rank_ub > 0:
                # rows-mode early abort (spasm_echelonize.c:84-95): test
                # the unconsumed rows, a prefetched block included
                rem0 = processed - (prefetched[0] if prefetched else 0)
                if n - rem0 > B and completion(np.arange(rem0, n)):
                    log.info("[finish/device] early abort: remaining "
                             "%d rows lie in the span", n - rem0)
                    break
        # register the basis (final back-reduced rows) into U
        with phase("basis_register"):
            Rall, jall = basis.export()
            real = jall < M - 1
            if np.any(real):
                jr = jall[real]
                keep = np.nonzero(real)[0]
                Rr = mesh_ctx.gather(mesh_ctx.smap(
                    lambda t: t[torch.as_tensor(keep, device=t.device)],
                    Rall), site=5)
                self.U.add_dense_rows_device(Rr, q_ext, q_ext[jr])
        log.info("[finish/device] done in %.1fs, %d new pivots",
                 time.time() - t0, self.U.n - old_un)

    @annotate("finish_gplu")
    def finish_gplu(self, S: CSR, p: np.ndarray, n: int, p_in):
        """Sparse Gilbert-Peierls finisher with leftmost pivoting and the
        probabilistic early abort (echelonize_GPLU,
        spasm_echelonize.c:54-187), on the host: native C++ when the
        library builds, its Python twin otherwise."""
        from . import native
        if native.available():
            return self._finish_gplu_native(S, p, n, p_in)
        return self._finish_gplu_py(S, p, n, p_in)

    def _finish_gplu_native(self, S: CSR, p: np.ndarray, n: int, p_in,
                            chunk: int = 8192):
        """Chunks of `chunk` rows through native.gplu; without L, a chunk
        that finds no pivot runs the completion test on the rest."""
        from . import native
        want_L = self.L is not None
        k = 0
        t0 = time.time()
        old_un = self.U.n
        # one snapshot; new rows append in amortized O(nnz)
        Ug = _GrowingCSR(self.U.snapshot_csr())
        while k < n:
            rows = np.asarray(p[k:k + chunk], np.int64)
            row_origin = (np.asarray(p_in, np.int64)[rows]
                          if p_in is not None else rows)
            # without L the run may stop once no free column remains;
            # with L every row must be solved (its coefficients)
            max_piv = n if want_L else min(n - k, self.m - self.U.n)
            if max_piv <= 0 and not want_L:
                break
            npiv, urows, (li, lj, lx), piv_origin = native.gplu(
                S, rows, row_origin, Ug, self.U.qinv, self.prime, want_L,
                max(max_piv, 1))
            if urows:
                goffs = np.zeros(len(urows) + 1, np.int64)
                goffs[1:] = np.cumsum([len(c) for c, _ in urows])
                gpiv = np.asarray([int(c[0]) for c, _ in urows], np.int64)
                gcols = np.concatenate([c for c, _ in urows])
                gvals = np.concatenate([v for _, v in urows])
                self.U.add_rows_bulk(gpiv, goffs, gcols.astype(np.int32),
                                     gvals.astype(np.int32))
                self.elim.append_segment(goffs, gcols, gvals, gpiv)
                for cols, vals in urows:
                    Ug.append_row(cols, vals)
            if want_L and li.size:
                self.L.add_batch(li, lj, lx)
            self.Lp.extend(int(v) for v in piv_origin)
            k += chunk
            if k < n and npiv == 0 and not want_L:
                if self.test_completion(S, p[k:], n - k):
                    log.info("[GPLU] early abort: completion test passed")
                    break
        log.info("[GPLU] done in %.1fs, %d new pivots",
                 time.time() - t0, self.U.n - old_un)

    def _finish_gplu_py(self, S: CSR, p: np.ndarray, n: int, p_in):
        """Row by row with the scalar triangular solver; without L, more
        than max(10, n / 100) rows in a row without a pivot run the
        completion test on the rest (once until the next pivot)."""
        m = self.m
        r_ub = min(S.n, m)
        x = np.zeros(m, dtype=np.int64)
        F = self.field
        rows_since_piv = 0
        early_done = False
        qinv = self.U.qinv
        Ug = _GrowingCSR(self.U.snapshot_csr())
        for k in range(n):
            if self.L is None and self.U.n == r_ub:
                log.info("[GPLU] full rank reached")
                break
            if (self.L is None and not early_done and rows_since_piv > 10
                    and rows_since_piv > n / 100):
                log.info("[GPLU] testing for early abort...")
                if self.test_completion(S, p[k:], n - k):
                    break
                early_done = True
            rows_since_piv += 1
            inew = int(p[k])
            iorig = int(p_in[inew]) if p_in is not None else inew
            pattern, x = sparse_triangular_solve(Ug, S, inew, qinv, x)
            live = pattern[x[pattern] != 0]
            cand = live[qinv[live] < 0]
            if self.L is not None:
                onpiv = live[qinv[live] >= 0]
                if onpiv.size:
                    self.L.add_batch(np.full(onpiv.size, iorig, np.int64),
                                     qinv[onpiv], x[onpiv])
            if cand.size == 0:
                continue
            jpiv = int(cand.min())
            pivval = int(x[jpiv])
            if self.L is not None:
                self.L.add(iorig, self.U.n, pivval)
            self.Lp.append(iorig)
            keep = np.sort(cand)
            vals = F.mul(np.int64(F.inverse(pivval)), x[keep])
            cp, vp = self.U.add_row(jpiv, keep, vals)
            self.elim.append_rows([(cp.astype(np.int64), vp, jpiv)],
                                  flush=False)
            Ug.append_row(cp, vp)
            rows_since_piv = 0
            early_done = False


def echelonize(A: CSR, opts: Optional[EchelonizeOptions] = None,
               device=None) -> LU:
    """Echelon form of A, optionally a full PLUQ: U (rank x m CSR, unit
    first-entry pivots) and qinv; with opts.L also L and p (A == L @ U
    when opts.complete, which implies L).  U and L materialize lazily.
    The finishers run on `device`: by default "cuda", or, inside
    `parallel.use_mesh(mesh)`, sharded over the mesh with the engine's
    own state on the mesh's first device (an explicit device of another
    type then raises).  The CPU runs only when passed explicitly or
    named by the mesh.  (reference: spasm_echelonize,
    spasm_echelonize.c:473-617)"""
    opts = EchelonizeOptions() if opts is None else dataclasses.replace(opts)
    if opts.complete:
        opts.L = True
    if opts.L:
        opts.enable_tall_and_skinny = False
    mesh_dev = mesh_ctx.mesh_device()
    if mesh_dev is not None:
        if device is not None and torch.device(device).type != mesh_dev.type:
            raise ValueError(f"echelonize: device={device} under a mesh of "
                             f"{mesh_dev.type} devices")
        device = mesh_dev
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        # small L-mode inputs never touch the device: fail here rather
        # than finish them on the host behind the caller's back
        raise RuntimeError("echelonize: CUDA is not available; pass "
                           "device='cpu' to run on the host")

    n, m = A.n, A.m
    t0 = time.time()
    log.info("[echelonize] start on %d x %d, %d nnz", n, m, A.nnz)
    eng = _Engine(A, opts, device)
    S = A
    p_in = None                # original row of each row of S (None: S = A)
    npiv = 0
    p = np.arange(n, dtype=np.int64)
    status = 0
    rnd = 0
    density = A.nnz / max(n * m, 1)

    # checkpoint/resume: a file of this input and these options resumes
    # the round loop at its round, or the finishers at their entry
    ckfile = opts.checkpoint_file
    fp = eng.fingerprint if ckfile else None
    resume_phase = None
    dense_processed = 0
    if ckfile:
        state = ckpt.load_checkpoint(ckfile, fp, A.prime, opts.L,
                                     opts.complete)
        if state is not None:
            ckpt.restore_engine(eng, state)
            S = ckpt.restored_S(state, A.prime)
            p_in = state.get("p_in")
            rnd = int(state["rnd"])
            density = float(state["density"])
            status = int(state["status"])
            resume_phase = int(state["phase"])
            npiv = int(state["npiv"])
            p = state["p"] if "p" in state \
                else np.arange(S.n, dtype=np.int64)
            dense_processed = int(state["processed"])
            log.info("[checkpoint] resumed from %s: phase=%d rnd=%d "
                     "rank=%d", ckfile, resume_phase, rnd, eng.U.n)

    def save(phase_, **kw):
        """One snapshot of the current loop state."""
        with phase("checkpoint_save"):
            ckpt.save_checkpoint(ckfile, fingerprint=fp, engine=eng, S=S,
                                 p_in=p_in, rnd=rnd, phase=phase_,
                                 density=density, **kw)

    in_finisher = resume_phase in (ckpt.PHASE_FINISH, ckpt.PHASE_DENSE)
    # bytes per element of the reduced basis and the finisher's blocks
    # (int16 while p <= 65535); the wider tiers get a quarter of the
    # width, as in the JAX package.  Under an active mesh the reduced
    # basis shards its width over 'cols' (SP axis), so the width cap
    # grows and the per-device basis bytes shrink by col_quantum().
    itemsize = 2 if A.prime <= 65535 else 4
    kcols = mesh_ctx.col_quantum()
    wcap = (opts.device_dense_width if itemsize == 2
            else opts.device_dense_width // 4) * kcols
    if mesh_dev is not None:
        mesh_ctx.count(7)
    while not in_finisher and rnd < opts.max_round:
        # one range per round: its pivots, density estimate and Schur
        # complement (and the round's checkpoint save)
        with phase("round"):
            if S.nnz == 0:
                status = 1
                break
            log.info("[echelonize] round %d", rnd)
            npiv, p = eng.extract_structural(S, p_in)
            eng.rounds.append({"pivots": npiv})
            if eng.U.n == m and not opts.L:
                log.info("[echelonize] full column rank from structural "
                         "pivots")
                status = 1
                break
            # once the free columns fit a dense device block, the remaining
            # rank belongs to the device finisher: no further sparse rounds
            nfree = m - eng.U.n
            basis_bytes = (eng.U.n + min(S.n - npiv, nfree)) * nfree \
                * itemsize // kcols
            if (not opts.L and opts.enable_dense
                    and 0 < nfree <= wcap
                    and (S.n - npiv) * nfree >= opts.device_dense_min
                    and basis_bytes <= opts.device_dense_mem):
                log.info("[echelonize] %d free columns fit the device "
                         "finisher; skipping sparse rounds", nfree)
                status = 3
                break
            if npiv < opts.min_pivot_proportion * min(S.n, m - eng.U.n):
                log.info("[echelonize] not enough pivots found; stopping")
                status = 2
                break
            U_csr = eng.U.snapshot_csr()
            with phase("density_estimate"):
                # fresh sample rows every round (spasm_schur.c:24)
                density = estimate_density(S, p[npiv:], S.n - npiv, U_csr,
                                           eng.U.qinv, 100, seed=1 + rnd)
            eng.rounds[-1]["density"] = density
            if density > opts.sparsity_threshold:
                log.info("[echelonize] Schur complement is dense (%.2f%%)",
                         100 * density)
                status = 2
                break
            nrows_s = S.n - npiv
            use_rb_schur = (eng.L is None and nfree > 0
                            and eng.U.n * nfree * itemsize
                            <= opts.device_dense_mem // 2
                            and nrows_s * m >= (1 << 21))
            with phase("schur_sparse"):
                if use_rb_schur:
                    S, p_in = eng.schur_sparse_reduced(S, p[npiv:], nrows_s,
                                                       p_in)
                else:
                    S, p_in = schur_sparse(S, p[npiv:], nrows_s,
                                           LU(eng.U.n, U_csr, eng.U.qinv),
                                           eng.L, p_in, eliminator=eng.elim)
            eng.rounds[-1]["schur_nnz"] = S.nnz
            log.info("[echelonize] round %d: Schur complement %d x %d, %d nnz",
                     rnd, S.n, m, S.nnz)
            npiv = 0
            p = np.arange(S.n, dtype=np.int64)
            rnd += 1
            if ckfile:
                save(ckpt.PHASE_ROUND)

    if status != 1:
        nrem = S.n - npiv
        if ckfile and not in_finisher:
            save(ckpt.PHASE_FINISH, p=p, npiv=npiv, status=status)
        # a save repacks U + S (O(nnz)); per dense block that can dominate
        # the finisher, so one save per interval at most (a resume redoes
        # the blocks after the last save)
        last_save = [time.time()]

        def dense_cb(processed):
            if time.time() - last_save[0] < opts.checkpoint_interval_s:
                return
            save(ckpt.PHASE_DENSE, p=p, npiv=npiv, status=status,
                 processed=processed)
            last_save[0] = time.time()

        cb = dense_cb if ckfile else None
        aspect = nrem / max(m - eng.U.n, 1)
        log.info("[echelonize] finishing; density=%.3f aspect=%.1f",
                 density, aspect)
        nfree = m - eng.U.n
        use_device_finish = (
            status == 3
            or (not opts.L and opts.enable_dense
                and 0 < nfree <= wcap
                and nrem * nfree >= opts.device_dense_min
                and (eng.U.n + min(nrem, nfree)) * nfree * itemsize
                // kcols <= opts.device_dense_mem
                and (density > opts.sparsity_threshold
                     or (opts.enable_tall_and_skinny
                         and aspect > opts.tall_and_skinny_ratio))))
        if resume_phase == ckpt.PHASE_DENSE:
            # back into the blocked dense finisher where the file left it
            eng.finish_dense(S, p[npiv:], nrem, p_in, checkpoint_cb=cb,
                             processed=dense_processed)
        elif use_device_finish:
            eng.finish_device_dense(S, p[npiv:], nrem)
        elif (opts.enable_tall_and_skinny
                and aspect > opts.tall_and_skinny_ratio):
            eng.finish_dense_lowrank(S, p[npiv:], nrem)
        elif opts.enable_dense and density > opts.sparsity_threshold:
            eng.finish_dense(S, p[npiv:], nrem, p_in, checkpoint_cb=cb)
        elif opts.enable_GPLU:
            eng.finish_gplu(S, p[npiv:], nrem, p_in)
        else:
            log.info("[echelonize] no finisher enabled; "
                     "incomplete echelonization returned")

    if ckfile and os.path.exists(ckfile):
        os.unlink(ckfile)

    r = eng.U.n
    fact = LU(r, None, eng.U.qinv.copy(), u_thunk=eng.U.snapshot_csr)
    if opts.L:
        fact._l_thunk = lambda: eng.L.build(n, r)
        fact.p = np.asarray(eng.Lp[:r], dtype=np.int64)
        fact.complete = opts.complete
    fact.rounds = eng.rounds
    nnz = eng.U.nnz()
    log.info("[echelonize] done in %.1fs; rank %d%s",
             time.time() - t0, r,
             ", %d nz in basis" % nnz if nnz >= 0 else "")
    return fact
