"""Reduced pivot basis: elimination in the compacted free-column domain.

Port of spasm_tpu/dense/reduced.py (see its docstring for the algebra).
The pivot basis U is unit upper triangular on its pivot columns, so
eliminating a row x against the whole basis has the closed form

    x_out|free = x|free - x|piv @ R,      R := (U|piv)^-1 @ (U|free)

with R the fully reduced basis restricted to the free columns.

Build (phase A): scatter every row's free entries into R, then run the
backward substitution R[k] -= sum_j U[k, pivcol_j] R[j] wave by wave
(kernel B1, dense/subst.py).  R is unique, so it equals the JAX
package's R bit for bit whichever route built it.

Use (phase B): a block of rows (actual rows, or random sparse-weight
combinations) given as flat entry slots forms as
    X = scatter(free entries) - sum_slots v_slot * R[ref_slot].
Above the d == 2 tier a CUDA block takes the sum through kernel B12
(`gather_combine`, csrc/combine.cu), one launch a chunk of rows that
skips dead slots; the d == 2 tier and CPU tensors take `_ref_combine`'s
slot loop.

Not ported: the JAX package's XLA scan build (`_phase_a_scan`) and its
log-depth tail (`_build_tail`, `_host_spmm_modp`), which exist to beat
XLA's per-level scan cost.

Under an active mesh (parallel/context.py) R shards its width over
'cols' (SP, the JAX package's P(None, 'cols')): column shard j holds R's
columns [j M / cols, (j + 1) M / cols) on its own device, scatters only
the free entries that fall there and runs kernel B1 on the same schedule
over its own columns (a column of R depends only on the same column of
the rows it references, so each shard is the single-device R's slice,
bit for bit; the JAX package skipped its Pallas build under a mesh only
because a Pallas call cannot be partitioned).  `form_block` forms each
shard's columns locally and returns a column-sharded block.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _cuda
from .elim import _size_bucket, _submod
from .modp import (_reduce31, device_field, dnorm64, matmul_digits,
                   storage_dtype)
from .subst import SUBST_COLS, nred_for, nred_wide, subst_waves
from ..parallel import context as mesh_ctx
from ..profiling import phase


def _ref_combine(V: torch.Tensor, R: torch.Tensor, refs: torch.Tensor,
                 p: int, small_acc: bool = False) -> torch.Tensor:
    """Exact sum_k V[:, k] * R[refs[:, k]] mod p, balanced int32 (S, M).

    V (S, K) balanced int32; refs (S, K) R row ids (dead slots point at a
    zero row).  The JAX version materialized the (S, K, M) gather; here
    each slot's rows are gathered in turn.  In the d == 2 tier products
    accumulate in int32, nred_for(p) of them between reductions;
    small_acc (caller guarantees K * (p//2)^2 < 2^31) takes all K in one
    accumulation.  Above it they accumulate in int64: d == 3 sums up to
    2^15 products (< 2^47 each) between reductions, d == 4 reduces each
    product (< 2^62) before the sum; there it is the plain version of
    kernel B12 (`gather_combine`), which CUDA blocks take."""
    S, K = V.shape
    d = device_field(p).ndigits
    if d > 2:
        out = torch.zeros((S, R.shape[1]), dtype=torch.int64,
                          device=R.device)
        for k in range(K):
            t = V[:, k:k + 1].to(torch.int64) * R[refs[:, k]].to(torch.int64)
            out += t if d == 3 else dnorm64(t, p)
            if d == 3 and (k + 1) % (1 << 15) == 0:
                out = dnorm64(out, p)
        return dnorm64(out, p).to(torch.int32)
    step = K if small_acc else nred_for(p)
    out = torch.zeros((S, R.shape[1]), dtype=torch.int32, device=R.device)
    for k0 in range(0, K, step):
        part = torch.zeros_like(out)
        for k in range(k0, min(K, k0 + step)):
            part += V[:, k:k + 1] * R[refs[:, k]].to(torch.int32)
        out = _reduce31(out + part, p)
    return out


def gather_combine(X: torch.Tensor, V: torch.Tensor, R: torch.Tensor,
                   refs: torch.Tensor, p: int, dead: int,
                   zero_last: bool) -> torch.Tensor:
    """Kernel B12: X - sum_k V[:, k] * R[refs[:, k]] mod p, balanced,
    written IN PLACE over X and returned; column w - 1 zeroed when
    zero_last.

    X (S, w) int32 balanced; V (S, K) int32 balanced; refs (S, K) int64
    R row ids, slots with refs == dead (R's zero row) or V == 0 skipped;
    R (rows, w) of `storage_dtype(p)`.  CUDA tensors only, contiguous,
    on one card, w % 8 == 0.  One launch, counted as "B12"."""
    S, w = X.shape
    K = V.shape[1]
    if not all(t.device.type == "cuda" and t.device == R.device
               for t in (X, V, refs)):
        raise ValueError("kernel B12 takes CUDA tensors on one card")
    if (X.dtype != torch.int32 or V.dtype != torch.int32
            or refs.dtype != torch.int64 or R.dtype != storage_dtype(p)):
        raise ValueError(f"kernel B12 takes int32 X and V, int64 refs and "
                         f"{storage_dtype(p)} R for p = {p}")
    if (V.shape != refs.shape or V.shape[0] != S or R.dim() != 2
            or R.shape[1] != w):
        raise ValueError("kernel B12: inconsistent shapes")
    if not all(t.is_contiguous() for t in (X, V, refs, R)) or w % 8 \
            or X.data_ptr() % 16 or R.data_ptr() % 16:
        raise ValueError("kernel B12 needs contiguous, 16-byte aligned "
                         "tensors and w % 8 == 0")
    if S == 0 or w == 0:
        return X
    L = _cuda.lib()
    # <<<>>> launches on the current device: make it R's
    with torch.cuda.device(R.device):
        err = L.spasm_gather_combine(
            X.data_ptr(), R.data_ptr(), int(R.dtype == torch.int16), w,
            refs.data_ptr(), V.data_ptr(), S, K, dead, nred_wide(p), p,
            int(zero_last), _cuda.stream_ptr(X))
    _cuda.check(err, "kernel B12 (spasm_gather_combine)")
    _cuda.launches["B12"] += 1
    return X


class ReducedBasis:
    """Device-resident R = (U|piv)^-1 @ (U|free) over the compacted
    free-column domain, plus block formation against it."""

    # element budget of one (Bc, M) int32 accumulator in form_block
    _GATHER_BUDGET = 1 << 27

    def __init__(self, m: int, prime: int, qfree: np.ndarray, npiv: int,
                 device="cuda"):
        self.m = m
        self.prime = prime
        self.device = torch.device(device)
        self.F = device_field(prime)
        self.nq = int(qfree.size)
        # width on the 2048 quantum, so R lines up with the JAX R (and,
        # under a mesh, every column shard holds whole B1 column chunks);
        # the pad is dead-column zeros
        self.mesh = mesh_ctx.current_mesh()
        q = int(np.lcm(2048, SUBST_COLS * mesh_ctx.col_quantum()))
        self.M = max(-(-(self.nq + 1) // q) * q, q)
        self.npad = _size_bucket(npiv + 1, 64)
        self.npiv = npiv
        self.dtype = storage_dtype(prime)
        # global column -> compact slot / R row (index m = dead)
        colmap = np.full(m + 1, self.M - 1, np.int64)
        colmap[qfree] = np.arange(self.nq)
        self._colmap_np = colmap
        self.colmap = torch.as_tensor(colmap, device=self.device)
        self.qfree = qfree
        self.R = None          # (npad, M); a column-sharded one under a mesh
        self.pivmap: Optional[torch.Tensor] = None
        self._pivcol_of_row: Optional[np.ndarray] = None
        self._shard_arrays = None

    @classmethod
    def from_numpy(cls, R: np.ndarray, qfree: np.ndarray,
                   pivcols: np.ndarray, m: int, prime: int,
                   device="cuda") -> "ReducedBasis":
        """A basis around an R built elsewhere (e.g. by the JAX package):
        R (npad, M), pivcols (npiv,) the pivot column of each R row."""
        pivcols = np.asarray(pivcols, np.int64)
        rb = cls(m, prime, np.asarray(qfree, np.int64), len(pivcols),
                 device)
        if R.shape != (rb.npad, rb.M):
            raise ValueError(f"R shape {R.shape} != {(rb.npad, rb.M)}")
        rb._set_pivots(pivcols)
        rb.R = mesh_ctx.shard_cols(
            torch.from_numpy(np.array(R)).to(rb.device, rb.dtype), rb.mesh,
            site=4)
        return rb

    def _set_pivots(self, pivcols: np.ndarray) -> np.ndarray:
        pivmap = np.full(self.m + 1, self.npad - 1, np.int64)
        pivmap[pivcols] = np.arange(self.npiv)
        self.pivmap = torch.as_tensor(pivmap, device=self.device)
        pcr = np.full(self.npad, self.m, np.int64)
        pcr[:self.npiv] = pivcols
        self._pivcol_of_row = pcr
        return pivmap

    # -- phase A -----------------------------------------------------------

    def build(self, offs: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              pivcols: np.ndarray, groups: np.ndarray):
        """Build R from the basis rows (flat CSR-style arrays).

        offs (npiv+1,), cols/vals flat entries, pivcols (npiv,) pivot
        column of each row, groups (npiv,) ints: rows with equal group
        never reference each other's pivot columns and only reference
        rows of strictly greater group."""
        pivcols = np.asarray(pivcols, np.int64)
        pivmap = self._set_pivots(pivcols)
        if self.mesh is None:
            devs, width = [self.device], self.M
        else:
            devs = mesh_ctx.shard_devices(self.mesh, 1)
            width = self.M // len(devs)
        Rs = [torch.zeros((self.npad, width), dtype=self.dtype, device=d)
              for d in devs]
        if self.npiv:
            self._build_subst(Rs, offs, cols, vals, pivcols,
                              np.asarray(groups), pivmap)
        self.R = Rs[0] if self.mesh is None else \
            mesh_ctx.Sharded(Rs, 1, self.mesh)

    def _build_subst(self, Rs, offs, cols, vals, pivcols, groups, pivmap):
        """Scatter every row's free entries into R, then run the
        substitution waves (descending groups) through kernel B1; Rs: R's
        column shards (one without a mesh), each scattered and swept on
        its own device with the same schedule."""
        order, rr, cc, vv, is_ref, refg = _ordered_entries(
            offs, cols, vals, pivcols, groups, pivmap, self.npad)
        is_free = ~is_ref & (cc != pivcols[order][rr])
        fr = order[rr[is_free]]
        fc = self._colmap_np[cc[is_free]]
        fv = vv[is_free]
        waves = _schedule(order, rr, vv, is_ref, refg, groups)
        width = Rs[0].shape[1]
        for j, R in enumerate(Rs):
            # CSR rows have unique columns: a plain indexed store
            mine = (fc >= j * width) & (fc < (j + 1) * width)
            if np.any(mine):
                dev = R.device
                R[torch.as_tensor(fr[mine], device=dev),
                  torch.as_tensor(fc[mine] - j * width, device=dev)] = \
                    torch.as_tensor(fv[mine], device=dev).to(R.dtype)
            if waves[0].size:
                subst_waves(R, *waves, self.prime)
        if self.mesh is not None:
            # what each shard received: its entries and the whole schedule
            mesh_ctx.count(4, 20 * fr.size + 4 * len(Rs) * sum(
                a.size for a in waves))

    # -- phase B -----------------------------------------------------------

    def set_entries(self, indices: np.ndarray, data: np.ndarray, nnz: int):
        """Upload the matrix entry arrays once (with one dead entry at
        index nnz: column m, value 0 — the target of padded slots)."""
        ind = np.empty(nnz + 1, np.int64)
        ind[:nnz] = indices[:nnz]
        ind[nnz] = self.m
        dat = np.zeros(nnz + 1, np.int32)
        dat[:nnz] = data[:nnz]
        self.dead_eidx = nnz
        self.indices = torch.as_tensor(ind, device=self.device)
        self.data = torch.as_tensor(dat, device=self.device)

    def _form_chunk(self, eidx: torch.Tensor, coeff: torch.Tensor, R,
                    arrays, base: int) -> torch.Tensor:
        """Eliminated compact block (Bc, w) int32 over R's columns [base,
        base + w) for rows given as flat entry slots: scatter(free
        entries) minus the weighted sum of the referenced R rows.  R: the
        (npad, w) basis columns; arrays: (indices, data, colmap, pivmap)
        on R's device."""
        p = self.prime
        w = R.shape[1]
        indices, data, colmap, pivmap = arrays
        small = self.F.ndigits == 2
        C = indices[eidx]                            # (Bc, K) columns
        if small:
            v = _reduce31(data[eidx] * coeff, p)     # |raw*coeff| < 2^30
        else:
            v = dnorm64(data[eidx].to(torch.int64)
                        * coeff.to(torch.int64), p).to(torch.int32)
        fc = colmap[C]
        pr = pivmap[C]
        # colliding entries sum: K balanced terms stay in int32 in the
        # d == 2 tier (the finisher caps its combination weight for
        # this), in int64 above it
        X = torch.zeros((eidx.shape[0], w),
                        dtype=torch.int32 if small else torch.int64,
                        device=R.device)
        if w == self.M:
            X.scatter_add_(1, fc, v.to(X.dtype))
        else:
            # a column shard: entries of other shards add 0 at column 0
            fc = fc - base
            mine = (fc >= 0) & (fc < w)
            X.scatter_add_(1, torch.where(mine, fc, 0),
                           torch.where(mine, v, 0).to(X.dtype))
        Xb = _reduce31(X, p) if small else dnorm64(X, p).to(torch.int32)
        K = eidx.shape[1]
        # reference slots scattered onto the dead column: keep it zero so
        # rowspan-dependent rows cannot claim a false pivot there
        last = base + w == self.M
        with phase("ref_combine"):
            if R.device.type == "cuda" and not small:
                return gather_combine(Xb, v, R, pr, p, self.npad - 1, last)
            delta = _ref_combine(v, R, pr, p, self._small_acc(K))
            out = _submod(Xb, delta, p)
            if last:
                out[:, w - 1] = 0
        return out

    def _arrays_on_shards(self):
        """(indices, data, colmap, pivmap) on every column shard's device
        (placed once per basis)."""
        if self._shard_arrays is None:
            reps = [mesh_ctx.broadcast(
                t, mesh_ctx.shard_devices(self.mesh, 1), site=5)
                for t in (self.indices, self.data, self.colmap,
                          self.pivmap)]
            self._shard_arrays = list(zip(*reps))
        return self._shard_arrays

    def form_block(self, eidx: np.ndarray, coeff: np.ndarray,
                   Bp: Optional[int] = None):
        """Eliminated compact block (Bp, M) for rows given as flat entry
        slots.  eidx/coeff: (B, K) host arrays (pad with dead_eidx/0).
        Rows past B come out zero.  Returns a device tensor of self.dtype;
        under a mesh a column-sharded one, each shard formed on its own
        device."""
        B, K = eidx.shape
        if Bp is None:
            Bp = B
        Bc = max(self._GATHER_BUDGET // self.M, 1)
        Bc = max(min(1 << (Bc.bit_length() - 1), Bp, 4096), 1)
        ep = np.full((Bp, K), self.dead_eidx, np.int64)
        ep[:B] = eidx
        cp = np.zeros((Bp, K), np.int32)
        cp[:B] = coeff
        if self.mesh is None:
            shards = [(self.R, (self.indices, self.data, self.colmap,
                                self.pivmap))]
        else:
            shards = list(zip(self.R.shards, self._arrays_on_shards()))
            mesh_ctx.count(5, (ep.nbytes + cp.nbytes) * len(shards))
        outs, base = [], 0
        for R, arrays in shards:
            dev = R.device
            e_d = torch.as_tensor(ep, device=dev)
            c_d = torch.as_tensor(cp, device=dev)
            out = torch.empty((Bp, R.shape[1]), dtype=self.dtype, device=dev)
            for b0 in range(0, Bp, Bc):
                out[b0:b0 + Bc] = self._form_chunk(
                    e_d[b0:b0 + Bc], c_d[b0:b0 + Bc], R, arrays, base)
            outs.append(out)
            base += R.shape[1]
        if self.mesh is None:
            return outs[0]
        return mesh_ctx.Sharded(outs, 1, self.mesh)

    def flat_rows(self, A_indptr: np.ndarray, rows: np.ndarray,
                  coeffs: Optional[np.ndarray] = None):
        """Host prep: flat (B, K) entry slots for combinations.

        rows (B, w) row ids (w == 1 for plain row blocks); coeffs
        (B, w) or None (all-ones).  Returns (eidx, coeff)."""
        rows = np.asarray(rows, np.int64)
        if rows.ndim == 1:
            rows = rows[:, None]
        B, w = rows.shape
        starts = A_indptr[rows]                    # (B, w)
        lens = (A_indptr[rows + 1] - starts).astype(np.int64)
        tot = lens.sum(axis=1)
        K = _k_bucket(int(tot.max(initial=1)))
        eidx = np.full((B, K), self.dead_eidx, np.int64)
        coeff = np.zeros((B, K), np.int32)
        lf = lens.reshape(-1)
        src = _flat_gather(starts.reshape(-1), lf)
        nrep = np.repeat(np.arange(B * w) // w, lf)
        pos_in_row = (np.arange(lf.sum())
                      - np.repeat(np.cumsum(lf) - lf, lf)
                      + np.repeat(np.cumsum(lens, axis=1).reshape(-1)
                                  - lf, lf))
        eidx[nrep, pos_in_row] = src
        if coeffs is None:
            coeff[nrep, pos_in_row] = 1
        else:
            coeff[nrep, pos_in_row] = np.repeat(
                np.asarray(coeffs, np.int32).reshape(-1), lf)
        return eidx, coeff

    def eliminate_full_width(self, Y: torch.Tensor):
        """Compact + eliminate full-width device rows Y (Sn, mp); the
        dead column mp-1 of Y must be zero.  Returns (Sn, M) int32
        (column-sharded under a mesh: the compact rows are sharded, the
        pivot coefficients broadcast, and each shard eliminates its
        columns against its part of R)."""
        mp = Y.shape[1]
        pcr = np.where(self._pivcol_of_row >= self.m, mp - 1,
                       self._pivcol_of_row)
        qsel = np.full(self.M, mp - 1, np.int64)
        qsel[:self.nq] = self.qfree
        Cf = Y[:, torch.as_tensor(pcr, device=Y.device)]   # (Sn, npad)
        Yq = Y[:, torch.as_tensor(qsel, device=Y.device)]
        if self.mesh is None:
            # R passes in its storage type: matmul_digits digitizes it
            # one contraction chunk at a time
            return _submod(Yq, matmul_digits(Cf, self.R, self.prime),
                           self.prime)
        Yq = mesh_ctx.shard_cols(Yq, self.mesh, site=4)
        Cfs = mesh_ctx.broadcast(Cf, [t.device for t in Yq.shards], site=4)
        return mesh_ctx.Sharded(
            [_submod(y, matmul_digits(c, R, self.prime), self.prime)
             for y, c, R in zip(Yq.shards, Cfs, self.R.shards)], 1,
            self.mesh)

    def _small_acc(self, K: int) -> bool:
        """True when K balanced products fit one int32 accumulator."""
        return K * (self.prime // 2) ** 2 < (1 << 31)


def subst_schedule(offs, cols, vals, pivcols, groups, pivmap, npad: int):
    """Kernel B1's schedule for the basis rows of `ReducedBasis.build`
    (flat CSR-style arrays, pivcols (npiv,), groups (npiv,)); pivmap
    (m + 1,) the R row of each pivot column, npad - 1 for the others.
    Returns (rows, ref_ptr, refs, coef, bounds) for `subst_waves`: rows
    the R rows that reference others, in descending group order; ref_ptr
    (len(rows) + 1,) offsets into refs (R rows) and coef (the referencing
    entries' values); bounds the waves' boundaries into rows (one wave
    per group).  Every reference lies in a strictly earlier wave.  All
    empty when no row references another."""
    order, rr, _, vv, is_ref, refg = _ordered_entries(
        offs, cols, vals, np.asarray(pivcols, np.int64), groups, pivmap,
        npad)
    return _schedule(order, rr, vv, is_ref, refg, groups)


def _ordered_entries(offs, cols, vals, pivcols, groups, pivmap, npad):
    """Every basis row's entries, rows in descending group order: order
    (npiv,) the processing order; per entry rr (position of its row in
    order), cc (column), vv (value), is_ref (it references another
    basis row), refg (that row's R row)."""
    groups = np.asarray(groups)
    lens = np.diff(offs).astype(np.int64)
    order = np.argsort(-groups, kind="stable")
    src = _flat_gather(np.asarray(offs)[order].astype(np.int64),
                       lens[order])
    rr = np.repeat(np.arange(len(order)), lens[order])   # ordered row idx
    cc = np.asarray(cols)[src].astype(np.int64)
    vv = np.asarray(vals)[src].astype(np.int32)
    own = cc == pivcols[order][rr]
    refg = pivmap[cc]                                  # R row / npad-1
    is_ref = (refg != npad - 1) & ~own
    return order, rr, cc, vv, is_ref, refg


def _schedule(order, rr, vv, is_ref, refg, groups):
    ref_cnt = np.bincount(rr[is_ref], minlength=len(order))
    live = ref_cnt > 0
    ref_ptr = np.zeros(int(live.sum()) + 1, np.int64)
    np.cumsum(ref_cnt[live], out=ref_ptr[1:])
    g_live = np.asarray(groups)[order][live]
    bounds = np.concatenate(
        ([0], np.nonzero(np.diff(g_live))[0] + 1, [g_live.size]))
    return (order[live], ref_ptr, refg[is_ref], vv[is_ref],
            bounds.astype(np.int64))


def _k_bucket(k: int) -> int:
    """Entry-slot bucket: powers of two to 32, then multiples of 16."""
    if k <= 4:
        return 4
    if k <= 32:
        b = 8
        while b < k:
            b <<= 1
        return b
    return -(-k // 16) * 16


def _flat_gather(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate ranges [starts[i], starts[i]+lens[i]) (vectorized)."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    rep = np.repeat(starts - np.concatenate(([0], np.cumsum(lens)[:-1])),
                    lens)
    return rep + np.arange(total)
