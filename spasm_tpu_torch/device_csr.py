"""Device-resident CSR: upload a sparse matrix once, then build dense row
blocks and run batched SpMVs on the device.

Port of the parts of spasm_tpu/device_csr.py that the ported paths use:
`DeviceCSR.__init__`, `densify` (`_densify`: the row blocks of
`schur_sparse`) and `spmv` (`_spmv_batch`: the finisher's completion
test).  `combine` has no caller in the port yet (ROADMAP: L-mode, the
solvers, the other CLI tools).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .csr import CSR
from .dense.block import row_bucket
from .dense.elim import _size_bucket
from .dense.modp import _reduce31, device_field, dnorm64
from .parallel import context as mesh_ctx


def _densify(indptr: torch.Tensor, indices: torch.Tensor,
             data: torch.Tensor, rows: torch.Tensor, nrows: int, p: int,
             Bp: int, mp: int, maxlen: int) -> torch.Tensor:
    """Scatter rows[:nrows] into a (Bp, mp) dense int32 block.  Entry
    slots beyond a row's length (and rows past nrows) add 0 into the
    dead column mp - 1.  Duplicate column entries sum, then one balanced
    reduction: in int32 in the d == 2 tier (maxlen * (p // 2) < 2^31),
    in int64 above it, where two balanced entries may pass 2^31."""
    starts = indptr[rows]                               # (Bp,)
    lens = indptr[rows + 1] - starts
    k = torch.arange(maxlen, device=rows.device)
    live = (k[None, :] < lens[:, None]) \
        & (torch.arange(Bp, device=rows.device) < nrows)[:, None]
    idx = torch.where(live, starts[:, None] + k[None, :], 0)
    cols = torch.where(live, indices[idx], mp - 1)
    vals = torch.where(live, data[idx], 0)
    if device_field(p).ndigits > 2:
        X = torch.zeros((Bp, mp), dtype=torch.int64, device=rows.device)
        X.scatter_add_(1, cols, vals.to(torch.int64))
        return dnorm64(X, p).to(torch.int32)
    X = torch.zeros((Bp, mp), dtype=torch.int32, device=rows.device)
    X.scatter_add_(1, cols, vals)
    return _reduce31(X, p)


def _spmv_batch(rowids: torch.Tensor, indices: torch.Tensor,
                data: torch.Tensor, XT: torch.Tensor, p: int, mp: int
                ) -> torch.Tensor:
    """Y[s] = XT[s] * A for a batch of dense coefficient vectors.
    XT (S, n) int32; returns (S, mp) int32 with the dead column zero.
    The scatter accumulates in int64 (integer atomics: exact and
    order-independent)."""
    t = dnorm64(XT[:, rowids].to(torch.int64)
                * data.to(torch.int64)[None, :], p)
    Y = torch.zeros((XT.shape[0], mp), dtype=torch.int64, device=XT.device)
    Y.index_add_(1, indices, t)
    Y = dnorm64(Y, p).to(torch.int32)
    Y[:, mp - 1] = 0
    return Y


class DeviceCSR:
    """A CSR matrix uploaded to device memory once.  Blocks and products
    are (rows, mp) with mp = bucket(m + 1) unless given, and a dead last
    column; blocks are int32, the eliminator's in-place dtype."""

    def __init__(self, A: CSR, device="cuda", mp: Optional[int] = None):
        self.n, self.m = A.n, A.m
        self.prime = A.prime
        self.device = torch.device(device)
        self.mp = mp if mp is not None else _size_bucket(A.m + 1, 64)
        nnz = A.nnz
        self.nnz = nnz
        lens = np.diff(A.indptr[:A.n + 1]).astype(np.int64)
        self.maxlen = int(lens.max()) if A.n else 0
        self.indptr = torch.as_tensor(
            np.asarray(A.indptr[:A.n + 1], np.int64), device=self.device)
        self.rowids = torch.as_tensor(np.repeat(np.arange(A.n), lens),
                                      device=self.device)
        # one dead entry past nnz (column mp - 1, value 0) keeps padded
        # gather slots in range
        ind = np.full(nnz + 1, self.mp - 1, np.int64)
        ind[:nnz] = A.indices[:nnz]
        dat = np.zeros(nnz + 1, np.int32)
        dat[:nnz] = A.data[:nnz]
        self.indices = torch.as_tensor(ind, device=self.device)
        self.data = torch.as_tensor(dat, device=self.device)
        # under a mesh: (mesh, per row shard (indptr, indices, data))
        self._replicas: tuple = (None, None)

    def _shard_arrays(self, mesh):
        """The entry arrays on every row shard's device (once per
        mesh)."""
        if self._replicas[0] is not mesh:
            reps = [mesh_ctx.replicated(t, mesh, site=6).shards
                    for t in (self.indptr, self.indices, self.data)]
            self._replicas = (mesh, list(zip(*reps)))
        return self._replicas[1]

    def densify(self, rows: np.ndarray, Bp: Optional[int] = None):
        """Dense (Bp, mp) int32 block of the given rows, balanced; rows
        past len(rows) are zero.  Upload: len(rows) int64s.  Under an
        active mesh the block comes back row-sharded: each row shard
        gathers only its own rows' entries, on its own device."""
        rows = np.asarray(rows, np.int64)
        B = len(rows)
        if Bp is None:
            Bp = row_bucket(max(B, 1))
        rp = np.zeros(Bp, np.int64)
        rp[:B] = rows
        mesh = mesh_ctx.current_mesh()
        if mesh is None:
            return _densify(self.indptr, self.indices, self.data,
                            torch.as_tensor(rp, device=self.device), B,
                            self.prime, Bp, self.mp, max(self.maxlen, 1))
        devs = mesh_ctx.shard_devices(mesh, 0)
        bs = Bp // len(devs)
        shards = []
        for i, (d, arrays) in enumerate(zip(devs, self._shard_arrays(mesh))):
            shards.append(_densify(
                *arrays, torch.as_tensor(rp[i * bs:(i + 1) * bs], device=d),
                min(max(B - i * bs, 0), bs), self.prime, bs, self.mp,
                max(self.maxlen, 1)))
        mesh_ctx.count(6, 8 * Bp)
        return mesh_ctx.Sharded(shards, 0, mesh)

    def spmv(self, XT: torch.Tensor) -> torch.Tensor:
        """Batched x*A for device-resident (S, n) coefficient rows."""
        return _spmv_batch(self.rowids, self.indices[:self.nnz],
                           self.data[:self.nnz], XT, self.prime, self.mp)
