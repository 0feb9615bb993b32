"""Batched elimination of dense row blocks against a sparse pivot basis U.

Port of spasm_tpu/dense/block.py (see its docstring for the algebra):
consecutive U rows form chunks whose effect on a block X is composed
exactly,
    alpha = X[:, J] @ (I + W)^-1,      X <- X - alpha @ U_chunk  (mod p),
with V = (I + W)^-1 @ U_chunk built once per chunk on its column union
C, and alpha parked back on the pivot columns (the scalar solver's
convention: coefficients on pivotal columns, Schur residue elsewhere).

Torch idiom: X is updated in place; a run of stacked chunks is a Python
loop of `_apply_chunk` (no scan).  Every chunk is applied, empty or not:
a chunk whose coefficients are all zero is inert, and testing that would
cost a host sync per chunk.  The JAX package's padding of each run's
chunk count to a power of two with dead chunks only bounded XLA
compilations and has no counterpart; the padding of chunk shapes to
buckets stays (it keeps the dead column the padded slots point at).

Under an active mesh (parallel/context.py) the block is row-sharded and
the chunk bases replicated, pure data parallelism: `pad_block` places
the row blocks, `eliminate_device` applies every run to each row shard
on its own device against that device's replica of the run (made once
per run and mesh), and `eliminate` gathers the rows back in order.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .elim import _size_bucket, _submod
from .modp import dnorm64, matmul_digits
from ..parallel import context as mesh_ctx

_DEFAULT_CHUNK = 1024
_DENSE_BUDGET = 32 << 20      # max int32 elements per densified chunk


class _Run(NamedTuple):
    """A stack of same-shape composed chunks, applied in order.  winv: for
    a chunk whose rows interact, (I + W)^-1, which turns the parked
    coefficient gather F into per-U-row coefficients F @ winv; None for
    composition-free chunks (winv == I there)."""
    cols: torch.Tensor      # (g, Cp) global column ids (padded -> m)
    jpos: torch.Tensor      # (g, Kp) pivot-column positions inside cols
    V: torch.Tensor         # (g, Kp, Cp) composed elimination rows
    k: int                  # real pivot rows across the run
    winv: Optional[torch.Tensor] = None   # (Kp, Kp), single-chunk runs


def _unit_upper_inverse_log(W: torch.Tensor, p: int) -> torch.Tensor:
    """(I + W)^-1 for strictly upper-triangular W mod p by log-squaring:
    W^K = 0, so (I + W)^-1 = sum_i (-W)^i, and S_2j = S_j (I + (-W)^j):
    ceil(log2 K) rounds of two digit matmuls."""
    k = W.shape[0]
    eye = torch.eye(k, dtype=torch.int64, device=W.device)
    N = dnorm64(-W.to(torch.int64), p)
    S = dnorm64(eye + N, p)
    P = matmul_digits(N, N, p)
    for _ in range(max(int(np.ceil(np.log2(max(k, 2)))), 1)):
        S = dnorm64(S + matmul_digits(S, P, p).to(torch.int64), p)
        P = matmul_digits(P, P, p)
    return S.to(torch.int32)


def _scatter_chunk_entries(rowrep, posidx, vals, kp: int, cp: int,
                           as_i8: bool = False) -> torch.Tensor:
    """Densify one chunk's sparse entries into a (kp, cp) block on their
    device; padded entries add 0 at a dead slot.  as_i8 (every value fits
    int8, e.g. the +-1 entries of boundary maps): one base-256 digit, so
    the applications run the d-product `matmul_digits_i8B`."""
    Ud = torch.zeros((kp, cp), dtype=torch.int32, device=vals.device)
    Ud.index_put_((rowrep, posidx), vals, accumulate=True)
    return Ud.to(torch.int8) if as_i8 else Ud


def _compose_chunk_entries(rowrep, posidx, vals, jpos, p: int, kp: int,
                           cp: int):
    """V = (I + W)^-1 @ U for a chunk whose rows interact; W[l, t] =
    Ud[l, jpos[t]] strictly above the diagonal (unit pivots).  Returns
    (V, Winv)."""
    Ud = _scatter_chunk_entries(rowrep, posidx, vals, kp, cp)
    W = torch.triu(Ud[:, jpos], diagonal=1)
    Winv = _unit_upper_inverse_log(W, p)
    return matmul_digits(Winv, Ud, p), Winv


def _apply_chunk(X: torch.Tensor, cols, jpos, V, winv, p: int,
                 park: bool = True) -> torch.Tensor:
    """One chunk update of X (B, mp), in place.  park=True writes the
    elimination coefficients back onto the pivot columns (F @ winv for a
    composed chunk); park=False leaves them zero (V's pivot columns are
    an embedded identity, so the update clears them)."""
    Xc = X[:, cols]                                   # (B, Cp)
    F = Xc[:, jpos]                                   # (B, Kp)
    Xc = _submod(Xc, matmul_digits(F, V, p), p)
    if park:
        Xc[:, jpos] = F if winv is None else matmul_digits(F, winv, p)
    X[:, cols] = Xc
    return X


def _apply_chunk_run(X: torch.Tensor, run: _Run, p: int,
                     park: bool = True) -> torch.Tensor:
    """Apply a run's chunks in order, in place."""
    for c in range(run.V.shape[0]):
        _apply_chunk(X, run.cols[c], run.jpos[c], run.V[c], run.winv, p,
                     park)
    return X


def row_bucket(B: int) -> int:
    """Padded row count of a dense block: _size_bucket(B, 8), rounded up
    to 8 * row_quantum() so that every row shard of an active mesh holds
    an equal slice (zero rows are inert)."""
    q = 8 * mesh_ctx.row_quantum()
    return -(-_size_bucket(B, 8) // q) * q


def _bucket(k: int) -> int:
    """Round up to a power of two (min 32)."""
    b = 32
    while b < k:
        b <<= 1
    return b


class UEliminator:
    """Incrementally built chunked eliminator for a growing pivot basis U,
    resident on `device`.  Rows are staged in engine order and composed
    into chunks only when an elimination needs them (paths that never
    eliminate, such as the rank finisher, pay nothing)."""

    # level-aligned chunks grow to this many rows; level-unknown or
    # interacting chunks stay at self.chunk (cheap compositions)
    _WIDE_CHUNK = 4096
    # runs stack same-shape chunks up to this many bytes of V
    _MERGE_LIMIT = 256 << 20

    def __init__(self, m: int, p: int, device="cuda",
                 chunk: int = _DEFAULT_CHUNK):
        self.m = m
        self.p = p
        self.device = torch.device(device)
        self.chunk = chunk
        self.runs: List[_Run] = []
        # under a mesh: the mesh and, by id(run.V), (run.V, its replicas)
        self._replicas: tuple = (None, {})
        # staged items in insertion order: ("seg", (offs, cols, vals,
        # pivcols, levels|None)) or ("def", thunk, k)
        self._staged: List[tuple] = []

    @property
    def nrows(self) -> int:
        return sum(r.k for r in self.runs) \
            + sum(len(it[1][3]) if it[0] == "seg" else it[2]
                  for it in self._staged)

    def append_segment(self, offs, cols, vals, pivcols, levels=None):
        """Stage a flat bulk of pivot-first rows (value 1 at pivcols[k]);
        `levels` as in append_rows."""
        if len(pivcols) == 0:
            return
        self._staged.append(("seg", (np.asarray(offs, np.int64),
                                     np.asarray(cols, np.int64),
                                     np.asarray(vals, np.int32),
                                     np.asarray(pivcols, np.int64),
                                     None if levels is None
                                     else np.asarray(levels, np.int64))))

    def append_rows(self, rows, flush: bool = True, levels=None):
        """rows: iterable of (cols int64[], vals int32[], pivcol), value 1
        at the pivot column.  `levels` (optional, one int per row):
        topological levels; equal-level rows never contain each other's
        pivot columns, which allows wide composition-free chunks."""
        rows = list(rows)
        if not rows:
            return
        offs = np.zeros(len(rows) + 1, np.int64)
        offs[1:] = np.cumsum([len(c) for c, _, _ in rows])
        self.append_segment(
            offs, np.concatenate([c for c, _, _ in rows]),
            np.concatenate([v for _, v, _ in rows]),
            np.asarray([pc for _, _, pc in rows], np.int64), levels)
        if flush:
            self.flush()

    def append_deferred(self, thunk, k: int) -> None:
        """Stage a registration thunk for k pivot rows; it runs at the
        next flush."""
        self._staged.append(("def", thunk, k))

    @staticmethod
    def _expand_segments(segs):
        out = []
        for offs, cols, vals, pivcols, levels in segs:
            for k in range(len(pivcols)):
                sl = slice(offs[k], offs[k + 1])
                out.append((cols[sl], vals[sl], int(pivcols[k]),
                            -1 if levels is None else int(levels[k])))
        return out

    def flush(self):
        staged, self._staged = self._staged, []
        run: List[tuple] = []
        for it in staged:                 # replay in insertion order
            if it[0] == "seg":
                run.append(it[1])
            else:
                if run:
                    self._flush_segments(self._expand_segments(run))
                    run = []
                it[1](self)
        if run:
            self._flush_segments(self._expand_segments(run))

    def _flush_segments(self, stage):
        # chunks aligned to level boundaries (same-level rows need no
        # composition), within the dense budget
        batches = []
        i = 0
        while i < len(stage):
            lv = stage[i][3]
            take = 1
            limit = min(len(stage) - i,
                        self._WIDE_CHUNK if lv >= 0 else self.chunk)
            while take < limit and stage[i + take][3] == lv \
                    and (lv >= 0 or take < self.chunk):
                take += 1
            if lv >= 0 and take < self.chunk:
                # short level run: merge consecutive short runs into one
                # (composed) chunk
                while take < min(len(stage) - i, self.chunk):
                    take += 1
            while take > 1:
                u = np.unique(np.concatenate(
                    [stage[j][0] for j in range(i, i + take)])).size
                if take * u <= _DENSE_BUDGET:
                    break
                take //= 2
            batches.append(stage[i:i + take])
            i += take
        dev = self.device
        pending: List[tuple] = []   # (cols (Cp,), jpos (Kp,), V, K, winv)
        for b in batches:
            rowrep, posidx, vals, jp, colsp, K, interacts = \
                self._prep_entries(b)
            kp, cp = jp.size, colsp.size
            args = [torch.as_tensor(a, device=dev)
                    for a in (rowrep, posidx, vals)]
            if interacts and K > 1:
                V, Winv = _compose_chunk_entries(
                    *args, torch.as_tensor(jp, device=dev), self.p, kp, cp)
            else:
                as_i8 = bool(np.abs(vals).max(initial=0) <= 127)
                V = _scatter_chunk_entries(*args, kp, cp, as_i8)
                Winv = None
            pending.append((colsp, jp, V, K, Winv))
        # stack consecutive same-shape composition-free chunks into runs,
        # bounded per run; composed chunks stand alone (they carry winv)
        j = 0
        while j < len(pending):
            if pending[j][4] is not None:
                colsp, jp, V, K, Winv = pending[j]
                self.runs.append(_Run(
                    torch.as_tensor(colsp, device=dev)[None],
                    torch.as_tensor(jp, device=dev)[None], V[None], K, Winv))
                j += 1
                continue
            V0 = pending[j][2]
            per = V0.numel() * V0.element_size()
            gmax = max(self._MERGE_LIMIT // max(per, 1), 1)
            j2 = j
            while (j2 < len(pending) and pending[j2][4] is None
                   and pending[j2][2].shape == V0.shape
                   and pending[j2][2].dtype == V0.dtype
                   and j2 - j < gmax):
                j2 += 1
            group = pending[j:j2]
            self.runs.append(_Run(
                torch.as_tensor(np.stack([g[0] for g in group]), device=dev),
                torch.as_tensor(np.stack([g[1] for g in group]), device=dev),
                torch.stack([g[2] for g in group]),
                sum(g[3] for g in group)))
            j = j2

    def _prep_entries(self, batch):
        """Host prep of one chunk: union support and flat sparse entries,
        padded to buckets.  Returns (rowrep (Ep,), posidx (Ep,), vals
        (Ep,), jp (Kp,), colsp (Cp,), K, interacts); `interacts` is False
        when no row's support holds another row's pivot column (W == 0)."""
        K = len(batch)
        cols_cat = np.concatenate([b[0] for b in batch])
        union = np.unique(cols_cat)
        pivcols = np.asarray([b[2] for b in batch], np.int64)
        Kp = _bucket(K)
        # at least one padded (dead) column: padded pivot slots point
        # there, never at a real column
        Cp = _bucket(union.size + 1)
        lens = np.asarray([b[0].size for b in batch], np.int64)
        E = int(lens.sum())
        Ep = _bucket(E)
        rowrep = np.zeros(Ep, np.int64)
        posidx = np.full(Ep, Cp - 1, np.int64)      # dead slot for padding
        vals = np.zeros(Ep, np.int32)
        rowrep[:E] = np.repeat(np.arange(K, dtype=np.int64), lens)
        posidx[:E] = np.searchsorted(union, cols_cat)
        vals[:E] = np.concatenate([b[1] for b in batch]).astype(np.int32)
        # each row holds its own pivot column: exactly K hits <=> W == 0
        interacts = int(np.isin(cols_cat, pivcols).sum()) > K
        jp = np.zeros(Kp, np.int64)
        jp[:K] = np.searchsorted(union, pivcols)
        if Kp > K:
            jp[K:] = union.size + np.arange(Kp - K) % (Cp - union.size)
        colsp = np.full(Cp, self.m, np.int64)     # padded cols -> dead col m
        colsp[:union.size] = union
        return rowrep, posidx, vals, jp, colsp, K, interacts

    def append_device_chunk(self, V: torch.Tensor, cols: np.ndarray,
                            jpos: np.ndarray, dead_col: bool = False):
        """Register a chunk already on the device: V (K, C) int32 mutually
        reduced rows with value 1 at the pivot slots (e.g. the pivot rows
        of a device RREF); cols (C,) global column ids; jpos (K,) pivot
        positions inside cols.  dead_col=True: V's trailing column is
        already dead (zero, mapped to m), so no column is added."""
        self.flush()        # engine order: staged rows first
        self._register_device_chunk(V, cols, jpos, dead_col)

    def _register_device_chunk(self, V: torch.Tensor, cols, jpos,
                               dead_col: bool = False, winv=None):
        """winv: for a composed device chunk (rows interact), the (K, K)
        inverse that turns parked coefficient gathers back into per-U-row
        coefficients (see _Run.winv)."""
        K, C = V.shape
        Kp = _bucket(K)
        Cp = C if dead_col else _bucket(C + 1)   # >= 1 dead column
        if (Kp, Cp) != (K, C):
            Vp = torch.zeros((Kp, Cp), dtype=V.dtype, device=V.device)
            Vp[:K, :C] = V
            V = Vp
        jp = np.zeros(Kp, np.int64)
        jp[:K] = np.asarray(jpos, np.int64)
        if Kp > K:
            # padded pivot slots point at a dead column
            jp[K:] = Cp - 1 if dead_col else \
                C + np.arange(Kp - K) % (Cp - C)
        colsp = np.full(Cp, self.m, np.int64)
        colsp[:C] = np.asarray(cols, np.int64)
        if winv is not None and Kp != K:
            wpad = torch.eye(Kp, dtype=torch.int32, device=V.device)
            wpad[:K, :K] = winv
            winv = wpad
        self.runs.append(_Run(torch.as_tensor(colsp, device=V.device)[None],
                              torch.as_tensor(jp, device=V.device)[None],
                              V[None], K, winv))

    def pad_block(self, X: np.ndarray):
        """Host block (B, m) -> padded device block (row and column
        buckets; the extra dead column m absorbs padded-slot writes).
        Under an active mesh the block is placed row-sharded (pure DP)."""
        B, m = X.shape
        shape = (row_bucket(B), _size_bucket(m + 1, 64))
        if mesh_ctx.current_mesh() is not None:
            Xp = np.zeros(shape, np.int32)
            Xp[:B, :m] = X
            return mesh_ctx.shard_rows(Xp, site=1)
        Xp = torch.zeros(shape, dtype=torch.int32, device=self.device)
        Xp[:B, :m] = torch.as_tensor(np.asarray(X, np.int32),
                                     device=self.device)
        return Xp

    def _dispatch_runs(self) -> List[_Run]:
        """Merge consecutive same-shape composition-free runs (up to
        _MERGE_LIMIT bytes of V) into one, so each is one stacked tensor;
        the merged list replaces self.runs (holding both would double the
        memory)."""
        merged: List[_Run] = []
        for run in self.runs:
            prev = merged[-1] if merged else None
            if (run.winv is None and prev is not None and prev.winv is None
                    and prev.V.shape[1:] == run.V.shape[1:]
                    and prev.V.dtype == run.V.dtype
                    and (prev.V.numel() + run.V.numel())
                    * run.V.element_size() <= self._MERGE_LIMIT):
                merged[-1] = _Run(torch.cat([prev.cols, run.cols]),
                                  torch.cat([prev.jpos, run.jpos]),
                                  torch.cat([prev.V, run.V]),
                                  prev.k + run.k)
            else:
                merged.append(run)
        self.runs = merged
        return merged

    def _shard_runs(self, mesh) -> List[List[_Run]]:
        """The dispatch runs replicated onto every row shard's device:
        [shard][run].  A run keeps its replicas while it stays in the
        list (cached per mesh, as the JAX package keyed its replicated
        runs by id(mesh)); a merged run is replicated anew."""
        runs = self._dispatch_runs()
        old_mesh, cache = self._replicas
        if old_mesh is not mesh:
            cache = {}
        fresh = {}
        for run in runs:
            hit = cache.get(id(run.V))
            if hit is None or hit[0] is not run.V:
                reps = [mesh_ctx.replicated(t, mesh, site=2).shards
                        if t is not None else [None] * mesh.shape["rows"]
                        for t in (run.cols, run.jpos, run.V, run.winv)]
                hit = (run.V, [_Run(c, j, v, run.k, w)
                               for c, j, v, w in zip(*reps)])
            fresh[id(run.V)] = hit
        self._replicas = (mesh, fresh)
        return [[fresh[id(run.V)][1][i] for run in runs]
                for i in range(mesh.shape["rows"])]

    def eliminate_device(self, Xd, park: bool = True):
        """Eliminate the padded device block Xd (Bp, mp), mp > m, in
        place against every registered row; returns Xd.  A row-sharded Xd
        (mesh_ctx.Sharded) is eliminated shard by shard, each on its own
        device."""
        self.flush()
        if isinstance(Xd, mesh_ctx.Sharded):
            for shard, runs in zip(Xd.shards, self._shard_runs(Xd.mesh)):
                for run in runs:
                    _apply_chunk_run(shard, run, self.p, park)
            return Xd
        for run in self._dispatch_runs():
            _apply_chunk_run(Xd, run, self.p, park)
        return Xd

    def eliminate(self, X: np.ndarray) -> np.ndarray:
        """Eliminate the host block X (B, m) against all registered U rows:
        coefficients on pivotal columns, Schur residue elsewhere."""
        self.flush()
        if not self.runs:
            return X
        B = X.shape[0]
        Xd = mesh_ctx.gather(self.eliminate_device(self.pad_block(X)),
                             site=1)
        return Xd[:B, :self.m].cpu().numpy()
