// Native host kernels for spasm_tpu_torch: the irregular sparse paths that
// stay on the host (symbolic graph walks + scalar Gilbert-Peierls
// elimination).  The port's own copy of spasm_tpu/native/spasm_kernels.cpp.
//
// Role-equivalent to the reference's C/OpenMP hot loops
// (the reference SpaSM's src/spasm_reach.c, spasm_triangular.c:109-147,
// spasm_pivots.c:146-294, spasm_echelonize.c:54-187) but written fresh in
// C++17 around a different execution model: batched row solves with
// per-thread scratch and deterministic in-order result assembly (no
// first-come critical sections), and handle-based result buffers fetched
// from Python over ctypes.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC
//
// GF(p) convention: balanced int32 representatives in [-(p-1)/2,(p-1)/2],
// int64 intermediates (exact for p <= 2^32 - 5).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

using i32 = int32_t;
using i64 = int64_t;

namespace {

struct FieldZp {
    i64 p, half;
    explicit FieldZp(i64 prime) : p(prime), half(prime / 2) {}
    inline i64 norm(i64 x) const {
        i64 r = x % p;
        if (r > half) r -= p;
        else if (r < -half) r += p;
        return r;
    }
    i64 inverse(i64 a) const {
        // extended Euclid on the nonnegative representative
        i64 aa = a % p;
        if (aa < 0) aa += p;
        i64 t = 0, newt = 1, r = p, newr = aa;
        while (newr != 0) {
            i64 q = r / newr;
            i64 tmp = t - q * newt; t = newt; newt = tmp;
            tmp = r - q * newr; r = newr; newr = tmp;
        }
        return norm(t);
    }
};

// CSR view over caller-owned arrays
struct CsrView {
    const i64 *ptr;
    const i32 *idx;
    const i32 *val;   // may be null (pattern)
    i32 nrows, ncols;
};

// ---------- result staging (handle-less: one global per result kind) ----

struct SolveResults {
    std::vector<i64> lens;      // entries per solved row
    std::vector<i32> cols;
    std::vector<i32> vals;
    void clear() { lens.clear(); cols.clear(); vals.clear(); }
};

SolveResults g_solve;

struct GpluResults {
    std::vector<i64> u_lens;    // per new U row
    std::vector<i32> u_cols;    // pivot first
    std::vector<i32> u_vals;
    std::vector<i64> l_i, l_j;  // L triplets
    std::vector<i32> l_x;
    std::vector<i64> piv_origin;  // original row id per new pivot
    void clear() {
        u_lens.clear(); u_cols.clear(); u_vals.clear();
        l_i.clear(); l_j.clear(); l_x.clear(); piv_origin.clear();
    }
};

GpluResults g_gplu;

// ---------- scalar sparse triangular solve machinery --------------------

// Workspace for one solver thread.
struct SolveScratch {
    std::vector<i64> x;          // dense accumulator
    std::vector<i32> stack, pos; // DFS stacks
    std::vector<i32> order;      // reach output, topological
    std::vector<uint8_t> seen;
    void init(i32 m) {
        x.assign(m, 0);
        stack.resize(m);
        pos.resize(m);
        order.reserve(m);
        seen.assign(m, 0);
    }
};

// Reachability of B-row pattern through the pivot graph of U.
// Appends reached columns to ws.order in topological order.
// mask_col (>= 0) is treated as non-pivotal for this row — used by RREF
// to exclude a row's own pivot from its re-elimination.
void reach_row(const CsrView &U, const i32 *bcols, i64 bn,
               const i64 *qinv, SolveScratch &ws, i64 mask_col = -1) {
    ws.order.clear();
    auto &stack = ws.stack;
    auto &pos = ws.pos;
    for (i64 t = 0; t < bn; ++t) {
        i32 root = bcols[t];
        if (ws.seen[root]) continue;
        int head = 0;
        stack[0] = root;
        pos[0] = 0;
        ws.seen[root] = 1;
        while (head >= 0) {
            i32 j = stack[head];
            i64 r = (j == mask_col) ? -1 : qinv[j];
            if (r < 0) {
                ws.order.push_back(j);
                --head;
                continue;
            }
            const i64 lo = U.ptr[r], hi = U.ptr[r + 1];
            i64 px = lo + pos[head];
            bool descended = false;
            while (px < hi) {
                i32 jj = U.idx[px];
                ++px;
                if (!ws.seen[jj]) {
                    pos[head] = (i32)(px - lo);
                    ++head;
                    stack[head] = jj;
                    pos[head] = 0;
                    ws.seen[jj] = 1;
                    descended = true;
                    break;
                }
            }
            if (!descended) {
                ws.order.push_back(j);
                --head;
            }
        }
    }
    std::reverse(ws.order.begin(), ws.order.end());
}

// Numeric phase: x * U = B[row].  On return ws.x holds coefficients on
// pivotal columns and the residue elsewhere; ws.order is the pattern.
void solve_row(const CsrView &U, const CsrView &B, i64 row,
               const i64 *qinv, i64 prime, SolveScratch &ws,
               i64 mask_col = -1) {
    const FieldZp F(prime);
    const i64 blo = B.ptr[row], bhi = B.ptr[row + 1];
    reach_row(U, B.idx + blo, bhi - blo, qinv, ws, mask_col);
    for (i32 j : ws.order) ws.x[j] = 0;
    for (i64 t = blo; t < bhi; ++t)
        ws.x[B.idx[t]] = B.val ? B.val[t] : 1;
    for (i32 j : ws.order) {
        ws.seen[j] = 0;                 // self-cleaning marks
        i64 xj = ws.x[j];
        if (xj == 0) continue;
        i64 r = (j == mask_col) ? -1 : qinv[j];
        if (r < 0) continue;
        // unit pivot at (r, j): x -= x[j] * U[r]
        for (i64 t = U.ptr[r]; t < U.ptr[r + 1]; ++t) {
            i32 jj = U.idx[t];
            ws.x[jj] = F.norm(ws.x[jj] - xj * (i64)U.val[t]);
        }
        ws.x[j] = xj;
    }
}

}  // namespace

extern "C" {

// Batched triangular solves: for each row id in `rows`, solve against U
// and stage the nonzero result entries (column-sorted).  Parallel over
// rows; results assembled in input order (deterministic).
// Returns the total number of staged entries.
// mask_cols (nullable): per solved row, one column treated as
// non-pivotal during that row's solve (RREF's "mask own pivot",
// cf. SpaSM src/spasm_rref.c:51-59), -1 = none.
i64 spasm_solve_batch(const i64 *Up, const i32 *Uj, const i32 *Ux,
                      i32 un, i32 m,
                      const i64 *Bp, const i32 *Bj, const i32 *Bx, i32 bn,
                      const i64 *rows, i64 nrows,
                      const i64 *qinv, i64 prime, i32 nthreads,
                      const i64 *mask_cols) {
    CsrView U{Up, Uj, Ux, un, m};
    CsrView B{Bp, Bj, Bx, bn, m};
    g_solve.clear();
    g_solve.lens.resize(nrows);
    std::vector<std::vector<i32>> cols(nrows), vals(nrows);
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel
#endif
    {
        SolveScratch ws;
        ws.init(m);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
        for (i64 k = 0; k < nrows; ++k) {
            solve_row(U, B, rows[k], qinv, prime, ws,
                      mask_cols ? mask_cols[k] : -1);
            std::sort(ws.order.begin(), ws.order.end());
            auto &ck = cols[k];
            auto &vk = vals[k];
            for (i32 j : ws.order) {
                if (ws.x[j] != 0) {
                    ck.push_back(j);
                    vk.push_back((i32)ws.x[j]);
                }
                ws.x[j] = 0;
            }
        }
    }
    i64 total = 0;
    for (i64 k = 0; k < nrows; ++k) {
        g_solve.lens[k] = (i64)cols[k].size();
        total += (i64)cols[k].size();
    }
    g_solve.cols.reserve(total);
    g_solve.vals.reserve(total);
    for (i64 k = 0; k < nrows; ++k) {
        g_solve.cols.insert(g_solve.cols.end(), cols[k].begin(),
                            cols[k].end());
        g_solve.vals.insert(g_solve.vals.end(), vals[k].begin(),
                            vals[k].end());
    }
    return total;
}

void spasm_solve_fetch(i64 *lens, i32 *cols, i32 *vals) {
    std::memcpy(lens, g_solve.lens.data(),
                g_solve.lens.size() * sizeof(i64));
    std::memcpy(cols, g_solve.cols.data(),
                g_solve.cols.size() * sizeof(i32));
    std::memcpy(vals, g_solve.vals.data(),
                g_solve.vals.size() * sizeof(i32));
    g_solve.clear();
}

// Greedy alternating-cycle-free pivot search (sequential, deterministic).
// pinv/qinv are updated in place; returns the number of new pivots.
// work_budget: total BFS expansions allowed before giving up (<=0 =
// unlimited).  Greedy pivots are valid incrementally, so an early stop
// keeps everything found so far; on expander-like matrices the full
// search is O(n*nnz) for marginal gain (the dense finisher on the device is
// cheaper than the symbolic search on the host).
i64 spasm_cycle_free_pivots(const i64 *Ap, const i32 *Aj, i32 n, i32 m,
                            i64 *pinv, i64 *qinv, i64 work_budget) {
    std::vector<int8_t> state(m, 0);   // 1 survivor, -1 reached
    std::vector<i32> queue(m);
    i64 npiv = 0;
    i64 work = 0;
    for (i32 i = 0; i < n; ++i) {
        if (work_budget > 0 && work > work_budget) break;
        if (pinv[i] >= 0) continue;
        const i64 lo = Ap[i], hi = Ap[i + 1];
        i32 head = 0, tail = 0;
        i64 surviving = 0;
        for (i64 t = lo; t < hi; ++t) {
            i32 j = Aj[t];
            if (qinv[j] < 0) {
                if (state[j] == 0) { state[j] = 1; ++surviving; }
            } else if (state[j] >= 0) {
                surviving -= state[j];
                state[j] = -1;
                queue[tail++] = j;
            }
        }
        while (head < tail && surviving > 0) {
            i32 j = queue[head++];
            i64 r = qinv[j];
            if (r < 0) continue;
            work += Ap[r + 1] - Ap[r];
            for (i64 t = Ap[r]; t < Ap[r + 1]; ++t) {
                i32 jj = Aj[t];
                if (state[jj] >= 0) {
                    surviving -= state[jj];
                    state[jj] = -1;
                    queue[tail++] = jj;
                }
            }
        }
        if (surviving > 0) {
            for (i64 t = lo; t < hi; ++t) {
                i32 j = Aj[t];
                if (state[j] == 1) {
                    pinv[i] = j;
                    qinv[j] = i;
                    ++npiv;
                    break;
                }
            }
        }
        for (i64 t = lo; t < hi; ++t) state[Aj[t]] = 0;
        for (i32 t = 0; t < tail; ++t) state[queue[t]] = 0;
    }
    return npiv;
}

// Sequential Gilbert-Peierls LU on the rows `rows` of S against an
// existing basis U0 (extended in place internally).  Leftmost-candidate
// pivoting; stops early once max_pivots pivots were found.
// qinv (size m) is updated in place.  Results staged in g_gplu.
// row_origin: original row id per processed S row (for L), or null.
// Returns the number of new pivots.
i64 spasm_gplu(const i64 *Sp, const i32 *Sj, const i32 *Sx, i32 sn, i32 m,
               const i64 *rows, i64 nrows, const i64 *row_origin,
               const i64 *U0p, const i32 *U0j, const i32 *U0x, i32 u0n,
               i64 *qinv, i64 prime, i32 want_L, i64 max_pivots) {
    const FieldZp F(prime);
    g_gplu.clear();
    CsrView S{Sp, Sj, Sx, sn, m};
    // dynamic U: start from U0, append new rows
    std::vector<i64> up(U0p, U0p + u0n + 1);
    std::vector<i32> uj(U0j, U0j + U0p[u0n]);
    std::vector<i32> ux(U0x, U0x + U0p[u0n]);
    i64 un = u0n;
    SolveScratch ws;
    ws.init(m);
    i64 newpiv = 0;
    for (i64 k = 0; k < nrows; ++k) {
        if (newpiv >= max_pivots) break;
        i64 row = rows[k];
        CsrView U{up.data(), uj.data(), ux.data(), (i32)un, m};
        solve_row(U, S, row, qinv, prime, ws);
        std::sort(ws.order.begin(), ws.order.end());
        // leftmost non-pivotal nonzero becomes the pivot
        i64 jpiv = -1;
        for (i32 j : ws.order)
            if (ws.x[j] != 0 && qinv[j] < 0) { jpiv = j; break; }
        i64 iorig = row_origin ? row_origin[k] : row;
        if (want_L) {
            for (i32 j : ws.order)
                if (ws.x[j] != 0 && qinv[j] >= 0) {
                    g_gplu.l_i.push_back(iorig);
                    g_gplu.l_j.push_back(qinv[j]);
                    g_gplu.l_x.push_back((i32)ws.x[j]);
                }
        }
        if (jpiv < 0) {
            for (i32 j : ws.order) ws.x[j] = 0;
            continue;
        }
        i64 pivval = ws.x[jpiv];
        if (want_L) {
            g_gplu.l_i.push_back(iorig);
            g_gplu.l_j.push_back(un);
            g_gplu.l_x.push_back((i32)pivval);
        }
        g_gplu.piv_origin.push_back(iorig);
        i64 beta = F.inverse(pivval);
        // append normalized row to U (pivot first)
        i64 len = 1;
        up.push_back(0);                       // will fix below
        uj.push_back((i32)jpiv);
        ux.push_back(1);
        for (i32 j : ws.order) {
            if (j != jpiv && ws.x[j] != 0 && qinv[j] < 0) {
                uj.push_back(j);
                ux.push_back((i32)F.norm(beta * ws.x[j]));
                ++len;
            }
            ws.x[j] = 0;
        }
        qinv[jpiv] = un;
        ++un;
        up[un] = up[un - 1] + len;
        g_gplu.u_lens.push_back(len);
        ++newpiv;
    }
    // stage new U rows (they live at the tail of uj/ux)
    i64 tail_start = U0p[u0n];
    g_gplu.u_cols.assign(uj.begin() + tail_start, uj.end());
    g_gplu.u_vals.assign(ux.begin() + tail_start, ux.end());
    return newpiv;
}

void spasm_gplu_sizes(i64 *sizes) {
    sizes[0] = (i64)g_gplu.u_lens.size();
    sizes[1] = (i64)g_gplu.u_cols.size();
    sizes[2] = (i64)g_gplu.l_i.size();
}

void spasm_gplu_fetch(i64 *u_lens, i32 *u_cols, i32 *u_vals,
                      i64 *l_i, i64 *l_j, i32 *l_x, i64 *piv_origin) {
    std::memcpy(u_lens, g_gplu.u_lens.data(),
                g_gplu.u_lens.size() * sizeof(i64));
    std::memcpy(u_cols, g_gplu.u_cols.data(),
                g_gplu.u_cols.size() * sizeof(i32));
    std::memcpy(u_vals, g_gplu.u_vals.data(),
                g_gplu.u_vals.size() * sizeof(i32));
    std::memcpy(l_i, g_gplu.l_i.data(), g_gplu.l_i.size() * sizeof(i64));
    std::memcpy(l_j, g_gplu.l_j.data(), g_gplu.l_j.size() * sizeof(i64));
    std::memcpy(l_x, g_gplu.l_x.data(), g_gplu.l_x.size() * sizeof(i32));
    std::memcpy(piv_origin, g_gplu.piv_origin.data(),
                g_gplu.piv_origin.size() * sizeof(i64));
    g_gplu.clear();
}

// Bipartite maximum matching (augmenting DFS with lookahead).
// jmatch (size n) / imatch (size m) filled with -1 for unmatched.
i64 spasm_matching(const i64 *Ap, const i32 *Aj, i32 n, i32 m,
                   i64 *jmatch, i64 *imatch) {
    std::fill(jmatch, jmatch + n, -1);
    std::fill(imatch, imatch + m, -1);
    std::vector<i64> marks(n, -1), look(n, 0);
    std::vector<i32> istack(n), pstack(n);
    std::vector<i32> jstack(n);
    i64 size = 0;
    const i64 r = std::min(n, m);
    for (i32 start = 0; start < n && size < r; ++start) {
        if (jmatch[start] >= 0) continue;
        int head = 0;
        istack[0] = start;
        bool found = false;
        while (head >= 0 && !found) {
            i32 i = istack[head];
            if (marks[i] != start) {
                marks[i] = start;
                const i64 lo = Ap[i], hi = Ap[i + 1];
                i64 px = lo + look[i];
                for (; px < hi; ++px) {
                    i32 j = Aj[px];
                    if (imatch[j] < 0) {
                        look[i] = px - lo;
                        jstack[head] = j;
                        for (int t = head; t >= 0; --t) {
                            imatch[jstack[t]] = istack[t];
                            jmatch[istack[t]] = jstack[t];
                        }
                        found = true;
                        break;
                    }
                }
                if (found) break;
                look[i] = hi - lo;
                pstack[head] = 0;
            }
            const i64 lo = Ap[i], hi = Ap[i + 1];
            i64 px = lo + pstack[head];
            bool descended = false;
            while (px < hi) {
                i32 j = Aj[px];
                i64 inew = imatch[j];
                ++px;
                if (marks[inew] == start) continue;
                pstack[head] = (i32)(px - lo);
                jstack[head] = j;
                ++head;
                istack[head] = (i32)inew;
                descended = true;
                break;
            }
            if (!descended) --head;
        }
        if (found) ++size;
    }
    return size;
}

// Faugere-Lachartre-on-columns pass: a non-pivotal row with an entry on
// a column absent from every pivotal row becomes pivotal there.
// Sequential-greedy (order-dependent, matches the Python reference).
i64 spasm_fl_column_pivots(const i64 *Ap, const i32 *Aj, i32 n, i32 m,
                           i64 *pinv, i64 *qinv) {
    std::vector<uint8_t> open_col(m, 1);
    for (i32 i = 0; i < n; ++i) {
        if (pinv[i] < 0) continue;
        for (i64 t = Ap[i]; t < Ap[i + 1]; ++t) open_col[Aj[t]] = 0;
    }
    i64 npiv = 0;
    for (i32 i = 0; i < n; ++i) {
        if (pinv[i] >= 0) continue;
        const i64 lo = Ap[i], hi = Ap[i + 1];
        for (i64 t = lo; t < hi; ++t) {
            i32 j = Aj[t];
            if (!open_col[j] || qinv[j] >= 0) continue;
            pinv[i] = j;
            qinv[j] = i;
            ++npiv;
            for (i64 u = lo; u < hi; ++u) open_col[Aj[u]] = 0;
            break;
        }
    }
    return npiv;
}

// Topological ordering of pivotal rows (DFS over the alternating-path
// digraph: pivotal column j -> row qinv[j] -> its columns).
// Writes the permutation p: pivotal rows first in topo order, then the
// remaining rows in index order.  Returns the number of pivotal rows.
i64 spasm_topo_order(const i64 *Ap, const i32 *Aj, i32 n, i32 m,
                     const i64 *pinv, const i64 *qinv, i64 *p) {
    std::vector<uint8_t> seen(m, 0);
    std::vector<i32> stack(m), pos(m);
    std::vector<i32> post;
    post.reserve(m);
    for (i32 root = 0; root < m; ++root) {
        if (qinv[root] < 0 || seen[root]) continue;
        int head = 0;
        stack[0] = root;
        pos[0] = 0;
        seen[root] = 1;
        while (head >= 0) {
            i32 j = stack[head];
            i64 r = qinv[j];
            if (r < 0) {
                post.push_back(j);
                --head;
                continue;
            }
            const i64 lo = Ap[r], hi = Ap[r + 1];
            i64 px = lo + pos[head];
            bool descended = false;
            while (px < hi) {
                i32 jj = Aj[px];
                ++px;
                if (!seen[jj]) {
                    pos[head] = (i32)(px - lo);
                    ++head;
                    stack[head] = jj;
                    pos[head] = 0;
                    seen[jj] = 1;
                    descended = true;
                    break;
                }
            }
            if (!descended) {
                post.push_back(j);
                --head;
            }
        }
    }
    i64 k = 0;
    for (auto it = post.rbegin(); it != post.rend(); ++it) {
        i64 r = qinv[*it];
        if (r >= 0) p[k++] = r;
    }
    const i64 npiv = k;
    for (i32 i = 0; i < n; ++i)
        if (pinv[i] < 0) p[k++] = i;
    return npiv;
}

// Topological levels of pivotal rows (dependency DAG scheduling).
//
// Input: pivotal rows `rows` (npiv, in a valid topological order: a
// row's support only contains pivot columns of rows at the same index
// or later), their pivot columns pinv.  Output levels: rows in the same
// level never contain each other's pivot columns, so a level can be
// applied to a dense block as ONE batched elimination with no
// intra-chunk composition (see dense/block.py).  O(nnz) forward pass.
void spasm_row_levels(const i64 *Aptr, const i32 *Aidx, i32 n, i32 m,
                      const i64 *rows, i64 npiv, const i64 *pinv,
                      i64 *levels) {
    std::vector<i64> col2k(m, -1);
    for (i64 k = 0; k < npiv; ++k) col2k[pinv[rows[k]]] = k;
    for (i64 k = 0; k < npiv; ++k) levels[k] = 0;
    for (i64 k = 0; k < npiv; ++k) {
        const i64 i = rows[k];
        const i64 lk = levels[k] + 1;
        for (i64 px = Aptr[i]; px < Aptr[i + 1]; ++px) {
            const i64 t = col2k[Aidx[px]];
            if (t > k && levels[t] < lk) levels[t] = lk;
        }
    }
}

i32 spasm_native_version() { return 3; }

}  // extern "C"
