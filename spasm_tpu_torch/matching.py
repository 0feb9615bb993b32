"""Bipartite maximum matching (Ford-Fulkerson with lookahead).

Vendored from spasm_tpu/matching.py, a port of SpaSM
src/spasm_matching.c: DFS augmenting paths with a
one-step-BFS "lookahead" and monotone-matching pruning (marks keyed by the
start row, so each row is examined once per augmentation attempt).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .csr import CSR


def maximum_matching(A: CSR) -> Tuple[int, np.ndarray, np.ndarray]:
    """Returns (size, jmatch, imatch): jmatch[i] = column matched to row i
    (or -1), imatch[j] = row matched to column j (or -1).
    (spasm_maximum_matching, spasm_matching.c:103-137)"""
    from . import native
    if native.available() and A.n and A.m:
        return native.matching(A)
    n, m = A.n, A.m
    indptr, indices = A.indptr, A.indices
    jmatch = np.full(n, -1, dtype=np.int64)
    imatch = np.full(m, -1, dtype=np.int64)
    marks = np.full(n, -1, dtype=np.int64)
    lookahead = np.zeros(n, dtype=np.int64)
    istack = np.empty(n, dtype=np.int64)
    jstack = np.empty(n, dtype=np.int64)
    pstack = np.empty(n, dtype=np.int64)
    size = 0
    r = min(n, m)
    for istart in range(n):
        if size >= r:
            break
        if jmatch[istart] >= 0:
            continue
        # DFS for an augmenting path from istart
        head = 0
        istack[0] = istart
        found = False
        while head >= 0 and not found:
            i = istack[head]
            if marks[i] != istart:
                marks[i] = istart
                # lookahead: any unmatched column on row i?
                lo, hi = indptr[i], indptr[i + 1]
                px = lo + lookahead[i]
                while px < hi:
                    j = indices[px]
                    if imatch[j] < 0:
                        lookahead[i] = px - lo
                        jstack[head] = j
                        # augment along the stack
                        for t in range(head, -1, -1):
                            ii, jj = istack[t], jstack[t]
                            imatch[jj] = ii
                            jmatch[ii] = jj
                        found = True
                        break
                    px += 1
                if found:
                    break
                lookahead[i] = hi - lo
                pstack[head] = 0
            # DFS over matched columns adjacent to row i
            lo, hi = indptr[i], indptr[i + 1]
            px = lo + pstack[head]
            descended = False
            while px < hi:
                j = indices[px]
                inew = imatch[j]
                px += 1
                if marks[inew] == istart:
                    continue
                pstack[head] = px - lo
                jstack[head] = j
                head += 1
                istack[head] = inew
                descended = True
                break
            if not descended:
                head -= 1
        if found:
            size += 1
    return size, jmatch, imatch


def structural_rank(A: CSR) -> int:
    """Size of a maximum matching (upper bound on the rank, usually equal;
    spasm.h:242)."""
    if A.n < A.m:
        size, _, _ = maximum_matching(A)
    else:
        size, _, _ = maximum_matching(A.transpose(keep_values=False))
    return size


def permute_row_matching(n: int, jmatch, p, qinv) -> np.ndarray:
    """Row matching of P*A*Q from a matching of A
    (spasm_matching.c:143-156)."""
    jmatch = np.asarray(jmatch, np.int64)
    p = np.asarray(p, np.int64)
    qinv = np.asarray(qinv, np.int64)
    out = jmatch[p]
    live = out >= 0
    out[live] = qinv[out[live]]
    return out


def permute_column_matching(m: int, imatch, pinv, q) -> np.ndarray:
    imatch = np.asarray(imatch, np.int64)
    q = np.asarray(q, np.int64)
    pinv = np.asarray(pinv, np.int64)
    out = imatch[q]
    live = out >= 0
    out[live] = pinv[out[live]]
    return out


def submatching(match, a: int, b: int, c: int) -> np.ndarray:
    """Matching restricted to rows [a, b) with columns shifted by c
    (spasm_matching.c:178-193)."""
    match = np.asarray(match, np.int64)
    out = match[a:b].copy()
    live = out >= 0
    out[live] -= c
    return out
