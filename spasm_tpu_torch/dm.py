"""Dulmage-Mendelsohn decomposition and strongly connected components.

Vendored from spasm_tpu/dm.py, ports of SpaSM src/spasm_dm.c and
spasm_scc.c:
  * coarse DM: a maximum matching (on A or A^T, whichever is wider) and
    two BFS sweeps over alternating paths determine the H/S/V blocks;
  * fine DM: iterative Tarjan SCC of the square S block.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import CSR, pinv as make_pinv
from .matching import maximum_matching


@dataclasses.dataclass
class DM:
    """Mirror of struct spasm_dm (spasm.h:74-82)."""
    p: np.ndarray       # (n,) row permutation
    q: np.ndarray       # (m,) column permutation
    r: np.ndarray       # (nb+1,) row block boundaries in A(p,q)
    c: np.ndarray       # (nb+1,) column block boundaries
    nb: int
    rr: np.ndarray      # (5,) coarse row decomposition
    cc: np.ndarray      # (5,) coarse column decomposition


def _bfs(A: CSR, wi, wj, imatch, jmatch, mark):
    """BFS over alternating paths from unmatched rows (spasm_dm.c:21-59),
    vectorized frontier-at-a-time: per level, one flat gather of the
    frontier rows' columns, mask-filter the unvisited, hop through the
    matching — O(nnz) numpy instead of a per-edge Python loop."""
    from .csr import _concat_ranges
    indptr, indices = A.indptr, A.indices
    frontier = np.nonzero(np.asarray(jmatch[:A.n]) < 0)[0]
    wi[frontier] = 0
    while frontier.size:
        starts = indptr[frontier]
        lens = (indptr[frontier + 1] - starts).astype(np.int64)
        cols = indices[_concat_ranges(starts, lens)].astype(np.int64)
        cols = np.unique(cols)
        cols = cols[wj[cols] < 0]
        wj[cols] = mark
        # a maximum matching admits no augmenting path, so every reached
        # column is matched; keep the guard for partial matchings
        nxt = imatch[cols]
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[wi[nxt] < 0]
        wi[nxt] = mark
        frontier = nxt


def strongly_connected_components(A: CSR) -> DM:
    """Iterative Tarjan SCC of a square matrix's digraph, emitting a block
    permutation (spasm_scc.c:14-117).  Blocks appear in topological order.
    """
    n, m = A.n, A.m
    assert n == m
    indptr, indices = A.indptr, A.indices
    index = np.full(n, -1, dtype=np.int64)       # discovery marks
    low = np.zeros(n, dtype=np.int64)
    onstack = np.zeros(n, dtype=bool)
    sccstack = []
    blocks = []
    counter = 0
    for root in range(n):
        if index[root] >= 0:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                sccstack.append(v)
                onstack[v] = True
            advanced = False
            lo, hi = indptr[v], indptr[v + 1]
            while pi < hi - lo:
                w = indices[lo + pi]
                pi += 1
                if index[w] < 0:
                    work[-1] = (v, pi)
                    work.append((int(w), 0))
                    advanced = True
                    break
                elif onstack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                comp = []
                while True:
                    w = sccstack.pop()
                    onstack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                blocks.append(comp)
            if work:
                u, _ = work[-1]
                low[u] = min(low[u], low[v])
    # blocks discovered in reverse topological order -> reverse them
    blocks.reverse()
    p = np.concatenate([np.asarray(b[::-1], np.int64) for b in blocks]) \
        if blocks else np.empty(0, np.int64)
    rr = np.zeros(len(blocks) + 1, dtype=np.int64)
    for k, b in enumerate(blocks):
        rr[k + 1] = rr[k] + len(b)
    return DM(p=p, q=p.copy(), r=rr.copy(), c=rr.copy(),
              nb=len(blocks), rr=np.zeros(5, np.int64),
              cc=np.zeros(5, np.int64))


def dulmage_mendelsohn(A: CSR) -> DM:
    """Coarse + fine DM decomposition (spasm_dm.c:90-176)."""
    n, m = A.n, A.m
    At = A.transpose(keep_values=False)
    if n < m:
        _, jmatch, imatch = maximum_matching(A)
    else:
        _, imatch, jmatch = maximum_matching(At)

    p = np.empty(n, dtype=np.int64)
    q = np.empty(m, dtype=np.int64)
    rr = np.zeros(5, dtype=np.int64)
    cc = np.zeros(5, dtype=np.int64)
    wi = np.full(n, -1, dtype=np.int64)
    wj = np.full(m, -1, dtype=np.int64)

    # find R0, then R3, C3 / find C0, then R1, C1
    _bfs(A, wi, wj, imatch, jmatch, 3)
    _bfs(At, wj, wi, jmatch, imatch, 1)

    # collect in q: C0, C1, C2, C3 ; p: R1, R2, R3, R0 (vectorized
    # masks; np.nonzero preserves the reference's ascending-j order)
    c0 = np.nonzero(wj == 0)[0]
    kc = c0.size
    q[:kc] = c0
    cc[1] = kc
    kr = 0
    for mark, cset in ((1, 1), (2, -1), (3, 3)):
        js = np.nonzero(wj == cset)[0]
        p[kr:kr + js.size] = imatch[js]
        q[kc:kc + js.size] = js
        kr += js.size
        kc += js.size
        cc[mark + 1] = kc
        rr[mark] = kr
    r0 = np.nonzero(wi == 0)[0]   # R0: unmatched rows
    p[kr:kr + r0.size] = r0
    kr += r0.size
    rr[4] = kr
    cc[4] = kc

    nb = 1
    r = np.asarray([0, n], dtype=np.int64)
    c = np.asarray([0, m], dtype=np.int64)
    out = DM(p=p, q=q, r=r, c=c, nb=nb, rr=rr, cc=cc)

    # ---- fine decomposition: SCC of the square S block ----
    if rr[2] - rr[1] == 0:
        return out
    qinv = make_pinv(q, m)
    B = A.permute(p, qinv, with_values=False)
    C = B.submatrix(int(rr[1]), int(rr[2]), int(cc[2]), int(cc[3]),
                    with_values=False)
    SCC = strongly_connected_components(C)
    n_scc = SCC.nb
    # update permutations in the S range
    p[rr[1]:rr[2]] = p[rr[1]:rr[2]][SCC.p]
    q[cc[2]:cc[3]] = q[cc[2]:cc[3]][SCC.q]
    r = np.zeros(n_scc + 3, dtype=np.int64)
    c = np.zeros(n_scc + 3, dtype=np.int64)
    for i in range(n_scc + 1):
        r[i + 1] = rr[1] + SCC.r[i]
        c[i + 1] = cc[2] + SCC.c[i]
    r[n_scc + 2] = n
    c[n_scc + 2] = m
    out.r, out.c, out.nb = r, c, n_scc + 2
    return out
