"""Schur complements (sparse and dense) and the density estimate.

Port of spasm_tpu/schur.py (the reference's spasm_schur.c): batched
triangular solves (`solve_rows`, native C++ or the scalar host solver),
the sampled density estimate, the sparse Schur complement of a round
(`schur_sparse`: rows densified on the device from one upload of the
matrix entries, eliminated by the chunked `UEliminator` (dense/block.py)
and packed back to nonzeros; or, below _DEVICE_THRESHOLD, solved on the
host), and the dense Schur blocks of the dense finishers, eliminated on
the device and left there.  Rows commit in input order, so S is
deterministic (the reference commits first come, first served).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .csr import CSR, _concat_ranges
from .dense.block import row_bucket
from .dense.elim import _size_bucket
from .hashing import PRNG
from .parallel import context as mesh_ctx
from .profiling import annotate
from .triangular import sparse_triangular_solve

_DEVICE_THRESHOLD = 1 << 21    # rows * m below this: the host path wins
_SCHUR_ROWS = 2048             # rows per device block of schur_sparse


def solve_rows(U: CSR, B: CSR, rows, qinv: np.ndarray, prime: int):
    """Batch of x*U = B[row] solves -> [(cols, vals)] (column-sorted,
    coefficients on pivotal columns, residue elsewhere).  Native C++
    (parallel) when it builds, the scalar host solver otherwise."""
    from . import native
    rows = np.asarray(rows, np.int64)
    if len(rows) and native.available():
        return native.solve_batch(U, B, rows, np.asarray(qinv, np.int64),
                                  prime)
    out = []
    x = np.zeros(U.m, dtype=np.int64)
    for r in rows:
        pattern, x = sparse_triangular_solve(U, B, int(r), qinv, x)
        live = np.sort(pattern[x[pattern] != 0])
        out.append((live.astype(np.int32), x[live].astype(np.int32)))
    return out


def estimate_density(A: CSR, p: np.ndarray, n: int, U: CSR,
                     qinv: np.ndarray, R: int = 100,
                     seed: int = 1) -> float:
    """Average residue density of R non-pivotal rows drawn from the
    SHA-256 PRNG and solved against U (spasm_schur.c:11-44)."""
    if n == 0 or A.m == U.n:
        return 0.0
    gen = PRNG.from_u64(A.prime, seed, 0xDE)
    sample = p[gen.uniform_array(R, n)]
    nnz = 0
    for cols, _ in solve_rows(U, A, sample, qinv, A.prime):
        nnz += int(np.count_nonzero(qinv[cols] < 0))
    return nnz / (A.m - U.n) / R


def _block_rows_dense(A: CSR, rows: np.ndarray) -> np.ndarray:
    """Densify the given rows of A into a (len(rows), m) int32 block."""
    X = np.zeros((len(rows), A.m), dtype=np.int32)
    for k, i in enumerate(rows):
        cols, vals = A.row(int(i))
        X[k, cols] = vals
    return X


def _scatter_rows(Bp: int, mp: int, device, rowrep, cols, vals
                  ) -> torch.Tensor:
    Xd = torch.zeros((Bp, mp), dtype=torch.int32, device=device)
    if rowrep.size:
        Xd[torch.as_tensor(rowrep, device=device),
           torch.as_tensor(cols, device=device)] = torch.as_tensor(
            vals, device=device)
    return Xd


def _block_rows_device(A: CSR, rows: np.ndarray, Bp: int, mp: int,
                       device):
    """Densify the given rows of A on `device`: only the block's sparse
    entries cross to it, then one scatter fills the (Bp, mp) block.
    Under an active mesh the block comes back row-sharded (Bp a multiple
    of row_quantum): each row shard receives and scatters only its own
    rows' entries, on its own device."""
    rows = np.asarray(rows, np.int64)
    starts = A.indptr[rows]
    lens = (A.indptr[rows + 1] - starts).astype(np.int64)
    gather = _concat_ranges(starts, lens)
    rowrep = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    cols = A.indices[gather].astype(np.int64)
    vals = A.data[gather].astype(np.int32)
    mesh = mesh_ctx.current_mesh()
    if mesh is None:
        return _scatter_rows(Bp, mp, device, rowrep, cols, vals)
    devs = mesh_ctx.shard_devices(mesh, 0)
    bs = Bp // len(devs)
    cut = np.searchsorted(rowrep, np.arange(len(devs) + 1) * bs)
    shards = [_scatter_rows(bs, mp, d, rowrep[a:b] - i * bs, cols[a:b],
                            vals[a:b])
              for i, (d, a, b) in enumerate(zip(devs, cut[:-1], cut[1:]))]
    mesh_ctx.count(6, 16 * rowrep.size)
    return mesh_ctx.Sharded(shards, 0, mesh)


def _origins(rows, p_in) -> np.ndarray:
    rows = np.asarray(rows, np.int64)
    return np.asarray(p_in, np.int64)[rows] if p_in is not None else rows


def _pack_nonzero_device(Xd, nrows: int, m: int):
    """The nonzero entries of Xd[:nrows, :m] (padded rows and the dead
    columns left out) as flat (rows, cols, vals) int32 numpy arrays,
    row-major sorted.  Only the packed entries cross to the host, in one
    copy, never the dense block (torch.nonzero waits for Xd).  A sharded
    Xd packs shard by shard: a row-sharded one (the Schur blocks, site
    6) in row order already, a column-sharded one (the reduced basis's
    blocks, site 5) merged back into row-major order."""
    if isinstance(Xd, mesh_ctx.Sharded):
        parts = []
        for b0, shard in zip(Xd.bounds(), Xd.shards):
            if Xd.axis == 0:
                r, c, v = _pack_nonzero_device(
                    shard, min(max(nrows - b0, 0), shard.shape[0]), m)
                parts.append((r + b0, c, v))
            else:
                r, c, v = _pack_nonzero_device(
                    shard, nrows, min(max(m - b0, 0), shard.shape[1]))
                parts.append((r, c + b0, v))
        r, c, v = (np.concatenate(x) for x in zip(*parts))
        if Xd.axis == 1:
            o = np.argsort(r, kind="stable")    # shards hold rising columns
            r, c, v = r[o], c[o], v[o]
        mesh_ctx.count(6 if Xd.axis == 0 else 5, 12 * r.size)
        return r, c, v
    sub = Xd[:nrows, :m]
    rc = torch.nonzero(sub)                         # (cnt, 2), row-major
    packed = torch.stack([rc[:, 0].to(torch.int32), rc[:, 1].to(torch.int32),
                          sub[rc[:, 0], rc[:, 1]].to(torch.int32)])
    r, c, v = packed.cpu().numpy()
    return r, c, v


def schur_sparse(A: CSR, p: np.ndarray, n: int, fact, L,
                 p_in: Optional[np.ndarray], eliminator=None,
                 use_device="auto") -> Tuple[CSR, np.ndarray]:
    """Schur complement of rows p[0:n] of A w.r.t. the pivots of fact.U.

    Returns (S, p_out): S has A.m columns, entries only on non-pivotal
    columns; row k of S is original row p_out[k].  Elimination
    coefficients go to the L builder when there is one.
    (reference: spasm_schur, spasm_schur.c:61-193)

    Device branch (use_device, "auto": n * m >= _DEVICE_THRESHOLD, and a
    non-empty eliminator): blocks of rows densify on the eliminator's
    device from one upload of A's entries (halved while a block exceeds
    256 Mi elements), are eliminated against the chunked basis and come
    back as packed nonzeros.  Host branch: batched triangular solves.
    (The JAX package's est_density and block_size arguments are left
    out: nothing reads the first, nothing sets the second.)"""
    qinv = fact.qinv
    m = A.m
    p_out = np.empty(n, dtype=np.int64)
    if use_device == "auto":
        use_device = n * m >= _DEVICE_THRESHOLD
    if use_device and eliminator is not None and eliminator.nrows > 0:
        from .device_csr import DeviceCSR
        mp = _size_bucket(m + 1, 64)
        bs = _SCHUR_ROWS
        while bs > 256 and bs * mp > (256 << 20):
            bs //= 2
        dcsr = DeviceCSR(A, device=eliminator.device, mp=mp)
        piv_mask = qinv >= 0
        tri_c: List[np.ndarray] = []
        tri_v: List[np.ndarray] = []
        counts = np.zeros(n, np.int64)
        for b0 in range(0, n, bs):
            idx = p[b0:b0 + bs].astype(np.int64)
            Xd = dcsr.densify(idx, Bp=row_bucket(len(idx)))
            Xd = eliminator.eliminate_device(Xd)
            r, c, v = _pack_nonzero_device(Xd, len(idx), m)
            piv = piv_mask[c]
            iorigs = _origins(idx, p_in)
            p_out[b0:b0 + len(idx)] = iorigs
            counts[b0:b0 + len(idx)] = np.bincount(r[~piv],
                                                   minlength=len(idx))
            tri_c.append(c[~piv])
            tri_v.append(v[~piv])
            if L is not None and np.any(piv):
                L.add_batch(iorigs[r[piv]], qinv[c[piv]], v[piv])
        # S straight from the row-major triplets
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSR(n, m, A.field, indptr,
                   np.concatenate(tri_c) if tri_c else np.empty(0, np.int32),
                   np.concatenate(tri_v) if tri_v else np.empty(0, np.int32)
                   ), p_out
    rows_out = []
    for k, (cols, vals) in enumerate(solve_rows(fact.U, A, p[:n], qinv,
                                                A.prime)):
        iorig = int(p_in[p[k]]) if p_in is not None else int(p[k])
        p_out[k] = iorig
        piv = qinv[cols] >= 0
        rows_out.append((cols[~piv], vals[~piv]))
        if L is not None and np.any(piv):
            L.add_batch(np.full(int(piv.sum()), iorig, np.int64),
                        qinv[cols[piv]], vals[piv])
    return CSR.from_rows(n, m, A.prime, rows_out), p_out


def schur_dense_block(A: CSR, rows: np.ndarray, p_in: Optional[np.ndarray],
                      qinv: np.ndarray, eliminator, L=None,
                      U_csr: Optional[CSR] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense Schur complement of the given rows w.r.t. U, on the host.

    Returns (S, q, p_out): S (len(rows), |q|) on the non-pivotal columns
    q; p_out maps block rows to original row ids.  Elimination
    coefficients of every row go to the L builder (the caller filters).
    (reference: spasm_schur_dense, spasm_schur.c:257-333)"""
    m = A.m
    q = np.nonzero(qinv < 0)[0]
    has_pivots = bool(np.any(qinv >= 0))
    if has_pivots and eliminator is not None and eliminator.nrows > 0 \
            and (U_csr is None or len(rows) * m >= _DEVICE_THRESHOLD):
        X = eliminator.eliminate(_block_rows_dense(A, rows))
    elif has_pivots:
        if U_csr is None:
            raise ValueError("schur_dense_block requires an eliminator or "
                             "a U snapshot when U is nonempty")
        X = np.zeros((len(rows), m), dtype=np.int32)
        for k, (cols, vals) in enumerate(
                solve_rows(U_csr, A, rows, qinv, A.prime)):
            X[k, cols] = vals
    else:
        X = _block_rows_dense(A, rows)
    p_out = _origins(rows, p_in)
    if L is not None:
        piv_cols = np.nonzero(qinv >= 0)[0]
        C = X[:, piv_cols]
        r, c = np.nonzero(C)
        if r.size:
            L.add_batch(p_out[r], qinv[piv_cols[c]], C[r, c])
    return X[:, q], q, p_out


@annotate("schur_block")
def schur_dense_block_device(A: CSR, rows: np.ndarray,
                             p_in: Optional[np.ndarray], qinv: np.ndarray,
                             eliminator, want_L: bool = False):
    """Dense Schur block of the dense finishers, left on the
    eliminator's device.  Returns (Xd, q, p_out): Xd (len(rows), |q|) on
    the non-pivotal columns q.

    want_L additionally returns (Cd, piv_cols): the elimination
    coefficients parked on the pivotal columns, as a device block
    (Bp, cpad) over the global pivot columns piv_cols; Xd is then
    (len(rows), qpad) with zero pad columns."""
    dev = eliminator.device
    q = np.nonzero(qinv < 0)[0]
    B = len(rows)
    mp = _size_bucket(A.m + 1, 64)
    Xd = _block_rows_device(A, rows, row_bucket(B), mp, dev)
    if eliminator.nrows > 0:
        Xd = eliminator.eliminate_device(Xd)
    # under a mesh: the eliminated row shards back on the engine's device
    Xd = mesh_ctx.gather(Xd, site=6)
    p_out = _origins(rows, p_in)
    if want_L:
        # the dead column mp - 1 is where padded gathers point: keep it 0
        Xd[:, mp - 1] = 0
        piv_cols = np.nonzero(qinv >= 0)[0]
        csel = np.full(_size_bucket(piv_cols.size + 1, 64), mp - 1,
                       np.int64)
        csel[:piv_cols.size] = piv_cols
        Cd = Xd[:, torch.as_tensor(csel, device=dev)]
        qsel = np.full(_size_bucket(q.size + 1, 64), mp - 1, np.int64)
        qsel[:q.size] = q
        return (Xd[:B][:, torch.as_tensor(qsel, device=dev)], q, p_out,
                (Cd, piv_cols))
    return Xd[:B][:, torch.as_tensor(q, device=dev)], q, p_out


def schur_dense_randomized(A: CSR, p: np.ndarray, n: int, U: CSR,
                           qinv: np.ndarray, N: int, w: int,
                           eliminator=None, seed_base: int = 0,
                           return_device: bool = False):
    """N random linear combinations of the Schur complement rows:
    w > 0: of w randomly chosen rows (first coefficient 1); w <= 0: of
    all n rows.  Returns (S, q) like schur_dense_block; return_device
    leaves the block on the eliminator's device.
    (reference: spasm_schur_dense_randomized, spasm_schur.c:346-413)"""
    m = A.m
    prime = A.prime
    q = np.nonzero(qinv < 0)[0]
    X = np.zeros((N, m), dtype=np.int64)
    F = A.field
    for k in range(N):
        gen = PRNG.from_u64(prime, k + seed_base, 0)
        y = X[k]
        if w <= 0:
            _combine_rows(A, p[:n], gen.zzp_array(n), y, F)
        else:
            # row choice and coefficients from the same per-combination
            # PRNG stream
            sel = gen.uniform_array(w, n)
            coeffs = np.empty(w, np.int32)
            coeffs[0] = 1
            if w > 1:
                coeffs[1:] = gen.zzp_array(w - 1)
            _combine_rows(A, p[sel], coeffs, y, F)
    Xi = F.narray(X).astype(np.int32)
    if eliminator is not None and eliminator.nrows > 0 \
            and (return_device or N * m >= _DEVICE_THRESHOLD):
        Xd = mesh_ctx.gather(eliminator.eliminate_device(
            eliminator.pad_block(Xi)), site=1)
        if return_device:
            return Xd[:N][:, torch.as_tensor(q, device=Xd.device)], q
        Xi = Xd[:N, :m].cpu().numpy()
    elif U.n:
        from . import native
        if native.available():
            Bm = CSR.from_dense(Xi, prime)
            out = np.zeros_like(Xi)
            for k, (cols, vals) in enumerate(
                    solve_rows(U, Bm, np.arange(N), qinv, prime)):
                out[k, cols] = vals
            Xi = out
        else:
            Xi = _eliminate_scalar(Xi, U, qinv)
    if return_device:
        return torch.as_tensor(Xi[:, q], device=eliminator.device), q
    return Xi[:, q], q


def _combine_rows(A: CSR, rows, coeffs, y: np.ndarray, F):
    """y += sum coeffs[k] * A[rows[k]] (int64 accumulator, term-reduced)."""
    for c, i in zip(coeffs, rows):
        cols, vals = A.row(int(i))
        if cols.size == 0 or c == 0:
            continue
        y[cols] = F.narray(y[cols] + np.int64(c) * vals.astype(np.int64))


def _eliminate_scalar(X: np.ndarray, U: CSR, qinv: np.ndarray) -> np.ndarray:
    """Host fallback: eliminate dense rows against U's pivots in order."""
    F = U.field
    upiv = np.full(U.n, -1, np.int64)
    cols_of = np.nonzero(qinv >= 0)[0]
    upiv[qinv[cols_of]] = cols_of
    X = X.astype(np.int64)
    for i in range(U.n):
        j = upiv[i]
        coeff = X[:, j].copy()
        live = np.nonzero(coeff)[0]
        if live.size == 0:
            continue
        cols, vals = U.row(i)
        X[np.ix_(live, cols)] = F.narray(
            X[np.ix_(live, cols)]
            - coeff[live, None] * vals.astype(np.int64)[None, :])
        X[live, j] = coeff[live]
    return F.narray(X).astype(np.int32)
