"""The plain reference that decides `correct`: NumPy and PyTorch only.

It imports nothing of the program and takes nothing the program made
but the answers it judges.  Every check is exact arithmetic mod p
(int64, or float64 where every sum stays below 2^53), so each number it
returns is a count whose limit is 0.

  * `echelon_faults`: U has r rows, each led by a 1 at its pivot column
    (its first stored entry), qinv names exactly those r pivots, and the
    pivot columns of U form a triangular system (its dependency graph is
    acyclic), so rank(U) = r.
  * `span_residual`: rowspan(A) is inside rowspan(U): y^T A is reduced
    by U in topological order, and the nonzeros left are counted (a row
    of A outside rowspan(U) leaves some with probability 1 - 1/p per
    random y).
  * `lu_residual`: A X == L (U X) for random X (Freivalds); with L of
    full column rank on its pivot rows p (`l_faults`) and U of full row
    rank, rank(A) = r exactly.
  * `dense_rank`: the rank of a dense matrix mod p by blocked Gaussian
    elimination (float64 products, exact for p < 2^21 at panel 256).
"""
from __future__ import annotations

import numpy as np
import torch

_CHUNK = 1 << 24             # entries of one gather in the sparse products


def mod(x: torch.Tensor, p: int) -> torch.Tensor:
    return torch.remainder(x, p)


def csr_mm(indptr, indices, data, X: torch.Tensor, p: int) -> torch.Tensor:
    """(CSR n x m) @ X (m x k) mod p, entries in [0, p), int64."""
    dev = X.device
    n = len(indptr) - 1
    out = torch.zeros((n, X.shape[1]), dtype=torch.int64, device=dev)
    indptr = np.asarray(indptr, np.int64)
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    for s in range(0, nnz, _CHUNK):
        e = min(nnz, s + _CHUNK)
        r = torch.as_tensor(rows[s:e], device=dev)
        c = torch.as_tensor(np.asarray(indices[s:e], np.int64), device=dev)
        v = mod(torch.as_tensor(np.asarray(data[s:e], np.int64), device=dev),
                p)
        out.index_add_(0, r, v[:, None] * X[c])
        out = mod(out, p)
    return out


def _acyclic_levels(nnodes: int, src: torch.Tensor, dst: torch.Tensor):
    """A topological order of a graph on nnodes nodes as levels
    ((nnodes,) int64; -1 on nodes in or behind a cycle): the index where
    every edge runs from a lower index to a higher, else Kahn's levels."""
    dev = src.device
    level = torch.full((nnodes,), -1, dtype=torch.int64, device=dev)
    if src.numel() == 0 or bool((src < dst).all()):
        return torch.arange(nnodes, device=dev)
    order = torch.argsort(src, stable=True)
    s_sorted, d_sorted = src[order], dst[order]
    ptr = torch.zeros(nnodes + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(s_sorted, minlength=nnodes), 0)
    indeg = torch.bincount(dst, minlength=nnodes)
    frontier = torch.nonzero(indeg == 0).flatten()
    lvl = 0
    while frontier.numel():
        level[frontier] = lvl
        starts, counts = ptr[frontier], ptr[frontier + 1] - ptr[frontier]
        total = int(counts.sum())
        if total == 0:
            break
        base = torch.repeat_interleave(starts - (torch.cumsum(counts, 0)
                                                 - counts), counts)
        tgt = d_sorted[base + torch.arange(total, device=dev)]
        indeg.index_add_(0, tgt, torch.full_like(tgt, -1))
        cand = torch.unique(tgt)
        frontier = cand[indeg[cand] == 0]
        lvl += 1
    return level


class Echelon:
    """U (CSR r x m, the program's answer) on `dev`, with its pivots."""

    def __init__(self, indptr, indices, data, r: int, m: int, p: int, dev):
        self.r, self.m, self.p, self.dev = r, m, p, dev
        indptr = np.asarray(indptr, np.int64)
        self.indptr = indptr
        self.rows = torch.as_tensor(
            np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                      np.diff(indptr)), device=dev)
        self.cols = torch.as_tensor(np.asarray(indices, np.int64), device=dev)
        self.vals = mod(torch.as_tensor(np.asarray(data, np.int64),
                                        device=dev), p)
        self.level = None


def echelon_faults(E: Echelon, qinv) -> int:
    """Count of the ways U breaks echelon form (0: U is an echelon basis
    of rank r whose pivots qinv names)."""
    dev, r, m = E.dev, E.r, E.m
    faults = 0
    nrows = len(E.indptr) - 1
    if nrows != r:
        return abs(nrows - r) + 1
    qinv = torch.as_tensor(np.asarray(qinv, np.int64), device=dev)
    if qinv.numel() != m:
        return 1
    lens = torch.as_tensor(np.diff(E.indptr), device=dev)
    faults += int((lens == 0).sum())
    first = torch.as_tensor(E.indptr[:-1], device=dev).clamp(
        max=max(E.cols.numel() - 1, 0))
    if E.cols.numel() == 0:
        return faults + (r > 0)
    piv = E.cols[first]
    lead = E.vals[first]
    faults += int(((lead != 1) & (lens > 0)).sum())
    if r:
        faults += int((qinv[piv] != torch.arange(r, device=dev)).sum())
    faults += abs(int((qinv >= 0).sum()) - r)
    faults += int((qinv >= r).sum())
    # dependencies: row j holds an entry on row k's pivot column
    q = qinv.clamp(min=-1)
    tgt = torch.where(E.cols < m, q[E.cols.clamp(max=m - 1)], -1)
    on_piv = (tgt >= 0) & (tgt != E.rows) & (tgt < r)
    level = _acyclic_levels(r, E.rows[on_piv], tgt[on_piv])
    faults += int((level < 0).sum())
    E.level, E.piv = level, piv
    return faults


def span_residual(E: Echelon, A_indptr, A_indices, A_data, Y: torch.Tensor
                  ) -> int:
    """Nonzeros of Y^T A (k random rows of rowspan(A)) left after
    reduction by U in topological order (echelon_faults first)."""
    p, dev = E.p, E.dev
    n = len(A_indptr) - 1
    X = torch.zeros((E.m, Y.shape[1]), dtype=torch.int64, device=dev)
    # X^T = Y^T A, formed as A^T Y by scattering rows of A
    rows = torch.as_tensor(np.repeat(np.arange(n, dtype=np.int64),
                                     np.diff(np.asarray(A_indptr, np.int64))),
                           device=dev)
    cols = torch.as_tensor(np.asarray(A_indices, np.int64), device=dev)
    vals = mod(torch.as_tensor(np.asarray(A_data, np.int64), device=dev), p)
    for s in range(0, cols.numel(), _CHUNK):
        e = s + _CHUNK
        X.index_add_(0, cols[s:e], vals[s:e, None] * Y[rows[s:e]])
        X = mod(X, p)
    if E.r == 0:
        return int((X != 0).sum())
    lev = E.level[E.rows]
    order = torch.argsort(lev, stable=True)
    rows_o, cols_o, vals_o = E.rows[order], E.cols[order], E.vals[order]
    nlev = int(E.level.max()) + 1
    bounds = torch.searchsorted(lev[order], torch.arange(
        nlev + 1, device=dev)).tolist()
    for t in range(nlev):
        s, e = bounds[t], bounds[t + 1]
        if s == e:
            continue
        rk = rows_o[s:e]
        c = X[E.piv[rk]]                     # (entries, k): row's coef
        X.index_add_(0, cols_o[s:e], -(vals_o[s:e, None] * c))
        X = mod(X, p)
    return int((X != 0).sum())


def l_faults(L_indptr, L_indices, L_data, pvec, n: int, r: int, p: int,
             dev) -> int:
    """Count of the ways L (n x r) fails to have full column rank r on
    its pivot rows p: p distinct rows of [0, n), L[p[k], k] != 0, and
    L[p, :] triangular (acyclic beside its diagonal)."""
    pv = np.asarray(pvec, np.int64)
    if len(L_indptr) - 1 != n or pv.size != r:
        return 1 + abs(pv.size - r)
    if r == 0:
        return 0
    if pv.min() < 0 or pv.max() >= n or np.unique(pv).size != r:
        return 1
    invp = np.full(n, -1, np.int64)
    invp[pv] = np.arange(r)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(L_indptr))
    cols = np.asarray(L_indices, np.int64)
    vals = np.asarray(L_data, np.int64) % p
    nz = vals != 0
    k = invp[rows]
    on = (k >= 0) & nz
    if cols.size and (cols.max() >= r or cols.min() < 0):
        return 1
    diag = np.zeros(r, bool)
    diag[k[on & (k == cols)]] = True
    faults = int((~diag).sum())
    off = on & (k != cols)
    # entry (p[k], j), j != k: c_j feeds row k of L[p, :]
    src = torch.as_tensor(cols[off], device=dev)
    dst = torch.as_tensor(k[off], device=dev)
    level = _acyclic_levels(r, src, dst)
    return faults + int((level < 0).sum())


def lu_residual(A, L, U, X: torch.Tensor, p: int) -> int:
    """Entries where A X != L (U X) mod p; A, L, U are (indptr, indices,
    data) triples."""
    AX = csr_mm(*A, X, p)
    for (_, idx, _), width in ((U, X.shape[0]), (L, len(U[0]) - 1)):
        if len(idx) and (int(np.max(idx)) >= width or int(np.min(idx)) < 0):
            return AX.numel()               # L and U do not compose
    UX = csr_mm(*U, X, p)
    LUX = csr_mm(*L, UX, p)
    if AX.shape != LUX.shape:
        return AX.numel()
    return int((AX != LUX).sum())


def dense_rank(M: torch.Tensor, p: int, block: int = 256) -> int:
    """Rank of the dense matrix M (any integers) mod p, on M's device:
    panels of `block` columns eliminated column by column in int64, the
    panel's row operations replayed on the trailing columns' pivot rows,
    and the rest of the trailing rows updated by one float64 product per
    panel (exact: block * (p - 1)^2 < 2^53)."""
    if block * (p - 1) ** 2 >= 1 << 53:
        raise ValueError("dense_rank: block * (p - 1)^2 must stay below 2^53")
    dev = M.device
    M = mod(M.to(torch.int64), p)
    n, m = M.shape
    inv = _inverses(p, dev)
    top = 0                                   # rows above are pivotal
    for c0 in range(0, m, block):
        if top == n:
            break
        c1 = min(m, c0 + block)
        P = M[top:, c0:c1]                    # a view: swaps land in M
        F = torch.zeros((n - top, c1 - c0), dtype=torch.int64, device=dev)
        scale = []
        k = 0                                 # pivots found in the panel
        for j in range(c1 - c0):
            if k == n - top:
                break
            nzr = torch.nonzero(P[k:, j])
            if nzr.numel() == 0:
                continue
            i = k + int(nzr[0, 0])
            if i != k:                        # swap rows k and i of M
                a, b = top + k, top + i
                M[[a, b]] = M[[b, a]]
                F[[k, i]] = F[[i, k]]
            s = inv[P[k, j]]
            scale.append(s)
            P[k] = mod(P[k] * s, p)
            f = P[k + 1:, j].clone()
            F[k + 1:, k] = f
            P[k + 1:] = mod(P[k + 1:] - f[:, None] * P[k], p)
            k += 1
        if k and c1 < m:
            T = M[top:, c1:]
            for t in range(k):                # the k pivot rows, in order
                T[t] = mod(T[t] * scale[t], p)
                if t + 1 < k:
                    T[t + 1:k] = mod(T[t + 1:k] - F[t + 1:k, t:t + 1]
                                     * T[t], p)
            if k < n - top:                   # the rest: one product
                upd = torch.matmul(F[k:, :k].to(torch.float64),
                                   T[:k].to(torch.float64))
                T[k:] = mod(T[k:] - torch.fmod(upd, p).to(torch.int64), p)
        top += k
    return top


def _inverses(p: int, dev) -> torch.Tensor:
    """inv[x] = x^(p-2) mod p for x in [0, p) (inv[0] = 0)."""
    x = torch.arange(p, dtype=torch.int64, device=dev)
    out = torch.ones_like(x)
    e = p - 2
    while e:
        if e & 1:
            out = out * x % p
        x = x * x % p
        e >>= 1
    return out
