"""Row-sweep RREF: kernels B2 and B3, their plain versions, and the
growing compact basis.

Port of spasm_tpu/dense/rowrref.py (see its docstring for the blocked
structure).  `_rref_rows` walks nb-row panels; each panel sweeps its
64-row sub-panels with a row-sweep kernel, normalizes them (one batched
Fermat inversion) and eliminates them from the rest of the panel with
one digit matmul; a second matmul back-reduces every row outside the
panel, so the processed prefix stays a fully reduced unit-pivot basis.

The two sweeps (contract: the division-free Jordan steps of one (64, M)
int32 sub-panel, in place, returning each row's pivot column or -1):
  * B2 `row_sweep`: leftmost-nonzero pivot rule (`_row_sweep_kernel`,
    rowrref.py:55 of the JAX package); used at M == 2048.  Two kernel
    variants, chosen by shape alone (`row_sweep_variant`): one cluster
    launch per sweep with the panel in shared memory (nb <= 64, M <=
    CLUSTER_COLS), else the pair of launches per Jordan step;
  * B3 `row_sweep_tiles`: per TILE_W-column tile, the leftmost nonzero
    within the tile (`_row_sweep_kernel2`, rowrref.py:126); used at
    M >= 4096.  Its pivots depend on the tile width, which is Hopper's
    (512), not the TPU's 2048.  The kernel and its plain version are
    left-looking: the sweep's transform W is built tile by tile (only
    live tiles are visited) and applied to P once, P <- W P.
A CUDA tensor launches the kernel (csrc/row_sweep.cu); a CPU tensor
takes the plain torch version of the same rule.  Any unit-pivot
echelon basis is valid downstream (qinv carries the columns); under
the leftmost rule the RREF is unique, so B2's output is bit-equal to
the JAX `_rref_rows(use_pallas=False)`.

Above the d == 2 tier (the kernels hold int32 updates only, as the JAX
package's Pallas sweeps do) every device takes `step_sweep`: the JAX
package's XLA step loop (leftmost rule, int64 products in `_mulsub`),
run on 64-row sub-panels like the kernels, with no host round trip per
row.  `CompactBasis` stores int32 rows there, and its products go
through the wide `matmul_digits`.

The last column of X must be dead (zero): gathers park unused indices
there.

Under an active mesh the finisher's blocks and `CompactBasis` are
column-sharded (parallel/context.py, as R is in dense/reduced.py):
`CompactBasis.apply` and `add` all-gather the (B, k) pivot-column
coefficients, then update each shard on its own device;
`rref_rows_device` gathers the block onto the mesh's first device, runs
the sweep there on the full width (the leftmost-pivot search crosses
shards; the kernel variant, chosen by width, stays that of one device)
and scatters the result back, as XLA's partitioner does for a custom
call on a sharded operand.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import _cuda
from ..parallel import context as mesh_ctx
from ..profiling import annotate
from .elim import _mulsub, _scale_rows, _submod
from .modp import (check_small, device_field, dnorm64, matmul_digits,
                   modinv, storage_dtype)

_SB = 64            # rows per sweep (sub-panel)
_TW = 2048          # width quantum: B2 at M == _TW, B3 at M >= 2 * _TW
TILE_W = 512        # B3's tile width (csrc/row_sweep.cu kTW)
CLUSTER_COLS = 8 * 1024    # B2's cluster variant: most columns (kCB *
                           # kCColsMax)
_CHUNK = 4096       # basis rows per CompactBasis product (memory bound)


def _check_sweep_input(P: torch.Tensor, p: int, nb_max: int):
    check_small(p, "kernels B2/B3")
    if P.dtype != torch.int32 or P.dim() != 2 or not P.is_contiguous():
        raise ValueError("P must be a contiguous 2-D int32 tensor")
    if not 0 < P.shape[0] <= nb_max:
        raise ValueError(f"sweep takes 1..{nb_max} rows, got {P.shape[0]}")


def row_sweep_variant(nb: int, M: int) -> str:
    """The B2 kernel variant an (nb, M) sub-panel takes, by shape alone:
    "cluster" for nb <= 64 and M <= CLUSTER_COLS (the panel in one
    cluster's shared memory, one launch per sweep), "pair" otherwise
    (sweep_find + sweep_update, two launches per Jordan step)."""
    return "cluster" if nb <= _SB and M <= CLUSTER_COLS else "pair"


def row_sweep(P: torch.Tensor, p: int) -> torch.Tensor:
    """Kernel B2: leftmost-rule Jordan sweep of P (nb, M) int32 in place,
    balanced; returns pivcol (nb,) int32 on P's device."""
    _check_sweep_input(P, p, 1024)
    if P.device.type == "cpu":
        return _row_sweep_plain(P, p)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    nb, M = P.shape
    pivcol = torch.empty(nb, dtype=torch.int32, device=P.device)
    L = _cuda.lib()
    variant = row_sweep_variant(nb, M)
    if variant == "cluster":
        if L.spasm_row_sweep_cluster_cols() != CLUSTER_COLS:
            raise RuntimeError("csrc/row_sweep.cu disagrees with "
                               "CLUSTER_COLS")
        with torch.cuda.device(P.device):     # launches on the current one
            err = L.spasm_row_sweep_cluster(P.data_ptr(), nb, M,
                                            pivcol.data_ptr(), p,
                                            _cuda.stream_ptr(P))
        n = 1
    else:
        st = torch.empty(nb + 2, dtype=torch.int32, device=P.device)
        with torch.cuda.device(P.device):
            err = L.spasm_row_sweep(P.data_ptr(), nb, M, pivcol.data_ptr(),
                                    st.data_ptr(), p, _cuda.stream_ptr(P))
        n = 2 * nb
    _cuda.check(err, f"kernel B2 ({variant} variant)")
    _cuda.launches["B2"] += n
    _cuda.launches[f"B2 {variant}"] += n
    _cuda.calls["B2"] += 1
    return pivcol


def row_sweep_tiles(P: torch.Tensor, p: int) -> torch.Tensor:
    """Kernel B3: tile-rule Jordan sweep of P (64, M) int32 in place,
    M % TILE_W == 0; returns pivcol (64,) int32 on P's device.  One
    launch per sweep; the card's live-tile count of each sweep goes to
    `live_tile_histogram(P.device)`."""
    _check_sweep_input(P, p, _SB)
    nb, M = P.shape
    if nb != _SB or M % TILE_W:
        raise ValueError(f"B3 takes ({_SB}, k * {TILE_W}), got {(nb, M)}")
    if P.device.type == "cpu":
        return _row_sweep_tiles_plain(P, p)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    if P.data_ptr() % 16:
        raise ValueError("B3 takes a 16-byte aligned panel")
    L = _cuda.lib()
    if L.spasm_tile_width() != TILE_W:
        raise RuntimeError("csrc/row_sweep.cu kTW disagrees with TILE_W")
    st = torch.empty(L.spasm_tile_state_size(), dtype=torch.int32,
                     device=P.device)
    hist = live_tile_histogram(P.device)
    with torch.cuda.device(P.device):         # launches on the current one
        err = L.spasm_row_sweep_tiles(P.data_ptr(), M, st.data_ptr(),
                                      hist.data_ptr(), p, _cuda.stream_ptr(P))
    _cuda.check(err, "kernel B3 (spasm_row_sweep_tiles)")
    _cuda.launches["B3"] += 1
    return st[_SB * _SB:_SB * _SB + _SB]


_live_hist = {}


def live_tile_histogram(device) -> torch.Tensor:
    """(65,) int32 on the card: entry t counts the B3 sweeps there that
    met t live tiles (tiles where a pivot was found).  Zero it in place
    to start a count."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _live_hist:
        _live_hist[device] = torch.zeros(_SB + 1, dtype=torch.int32,
                                         device=device)
    return _live_hist[device]


def _jordan_step(P: torch.Tensor, k: int, j: int, p: int) -> None:
    """P <- v*P - g (x) P[k] with v = P[k, j], g = P[:, j], g[k] = 0."""
    u = P[k].clone()
    g = P[:, j].clone()
    g[k] = 0
    P.copy_(_mulsub(u[j], P, g[:, None], u[None, :], p))


def _row_sweep_plain(P: torch.Tensor, p: int) -> torch.Tensor:
    """Plain version of B2 (the leftmost rule), in place."""
    nb, M = P.shape
    pivcol = torch.full((nb,), -1, dtype=torch.int32, device=P.device)
    for k in range(nb):
        nz = torch.nonzero(P[k])
        if nz.numel() == 0:
            continue
        j = int(nz[0, 0])
        _jordan_step(P, k, j, p)
        pivcol[k] = j
    return pivcol


@annotate("step_sweep")
def step_sweep(P: torch.Tensor, p: int) -> torch.Tensor:
    """The leftmost-rule Jordan sweep of P (nb, M) int32 in place, in
    torch ops on P's device (the JAX package's XLA step loop,
    rowrref.py:430-446): per row k, its leftmost nonzero j, then P <-
    v*P - g (x) P[k] with v = P[k, j], g = P[:, j], g[k] = 0.  No host
    sync: a zero row takes v = 1, g = 0, an identity update.  The d >= 3
    route of `rref_rows_device`, one `spasm/step_sweep` range a call;
    returns pivcol (nb,) int32."""
    nb, M = P.shape
    dev = P.device
    iota = torch.arange(nb, device=dev)
    pivcol = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    for k in range(nb):
        u = P[k].clone()
        nz = u != 0
        has = nz.any()
        j = torch.argmax(nz.to(torch.int32)).view(1)
        v = torch.where(has, u.index_select(0, j)[0], one)
        g = torch.where((iota != k) & has,
                        P.index_select(1, j)[:, 0], 0)
        P.copy_(_mulsub(v, P, g[:, None], u[None, :], p))
        pivcol[k] = torch.where(has, j[0].to(torch.int32), -one)
    return pivcol


def _mm_exact(A: torch.Tensor, B: torch.Tensor, p: int) -> torch.Tensor:
    """Balanced A @ B of balanced int32 operands with at most 64 terms:
    each product is below 2^30 and each sum below 2^36, so the float64
    product is exact (on the CPU and on the card)."""
    return dnorm64(torch.matmul(A.double(), B.double()).to(torch.int64),
                   p).to(torch.int32)


def _row_sweep_tiles_plain(P: torch.Tensor, p: int) -> torch.Tensor:
    """Plain version of B3, in place, step for step the kernel's
    left-looking algorithm: W accumulates the tiles' transforms (W = I
    at first); the next live tile is the first at or after the current
    one where a row not yet pivoted of W P has a nonzero; there each such
    row k in order finds its leftmost nonzero j of W[k] P[:, tile], and
    the Jordan step is applied to W alone; at the end P <- W P.  The
    reductions fall where the kernel's do, so every value is the same."""
    nb, M = P.shape
    tw = TILE_W
    W = torch.eye(nb, dtype=torch.int32, device=P.device)
    pivcol = torch.full((nb,), -1, dtype=torch.int32, device=P.device)
    col = [-1] * nb
    cstart = 0
    while cstart < M and -1 in col:
        unp = torch.tensor([k for k in range(nb) if col[k] < 0],
                           device=P.device)
        Y = _mm_exact(W[unp], P[:, cstart:], p)
        hit = torch.nonzero((Y != 0).any(dim=0))
        if hit.numel() == 0:
            break
        c0 = (cstart + int(hit[0, 0])) // tw * tw
        B = P[:, c0:c0 + tw]
        for k in range(nb):
            if col[k] >= 0:
                continue
            nz = torch.nonzero(_mm_exact(W[k:k + 1], B, p)[0])
            if nz.numel() == 0:
                continue
            j = int(nz[0, 0])
            g = _mm_exact(W, B[:, j:j + 1], p)[:, 0]
            v = _mm_exact(W[k:k + 1], B[:, j:j + 1], p)[0, 0]
            g[k] = 0
            W = _mulsub(v, W, g[:, None], W[k][None, :], p)
            col[k] = c0 + j
            pivcol[k] = c0 + j
        cstart = c0 + tw
    P.copy_(_mm_exact(W, P, p))
    return pivcol


def _rref_rows(X: torch.Tensor, p: int, nb: int, sweep) -> tuple:
    """Row-sweep RREF of X (B, M) balanced, B % nb == 0, nb % 64 == 0,
    last column dead.  X is updated IN PLACE.  Returns (X, pivcol):
    pivcol[i] >= 0: row i is a unit-pivot basis row with its pivot at
    pivcol[i], fully reduced against every other pivot row;
    pivcol[i] == -1: row i reduced to zero."""
    B, M = X.shape
    dev = X.device
    pivcol = torch.full((B,), -1, dtype=torch.int32, device=dev)
    iota_nb = torch.arange(nb, device=dev)
    iota_sb = torch.arange(_SB, device=dev)
    iota_B = torch.arange(B, device=dev)
    for q0 in range(0, B, nb):
        # No elimination against prior pivots is needed: the end-of-panel
        # back-reduction updates every row outside the panel, so this
        # panel already has zeros on all prior pivot columns.
        P = X[q0:q0 + nb].to(torch.int32, copy=True)
        pivl = torch.full((nb,), -1, dtype=torch.int32, device=dev)
        for off in range(0, nb, _SB):
            Ps = P[off:off + _SB].clone()
            pr = sweep(Ps, p)
            has = pr >= 0
            prs = torch.where(has, pr, M - 1).to(torch.int64)
            pvs = Ps[iota_sb, prs]
            inv = dnorm64(modinv(torch.where(has, pvs, 1), p), p)
            Ns = _scale_rows(inv, Ps, p)
            # eliminate the sub-panel's pivots from the rest of the panel
            insub = (iota_nb >= off) & (iota_nb < off + _SB)
            C = torch.where((~insub[:, None]) & has[None, :], P[:, prs], 0)
            P = _submod(P, matmul_digits(C, Ns, p), p)
            P[off:off + _SB] = Ns
            pivl[off:off + _SB] = pr
        # the panel's pivot rows are unit already (normalized per
        # sub-panel); back-reduce every other row against them
        X[q0:q0 + nb] = P.to(X.dtype)
        phas = pivl >= 0
        pcs2 = torch.where(phas, pivl, M - 1).to(torch.int64)
        inpanel = (iota_B >= q0) & (iota_B < q0 + nb)
        C2 = torch.where((~inpanel[:, None]) & phas[None, :], X[:, pcs2], 0)
        X.copy_(_submod(X, matmul_digits(C2, P, p), p))
        pivcol[q0:q0 + nb] = pivl
    return X, pivcol


def rref_rows_device(Xd, p: int, nb: int = 64):
    """Xd: (B, M) device tensor, last column dead, B % 64 == 0,
    M % 2048 == 0; reduced IN PLACE.  Returns (Xd, pivcol) with pivcol
    (B,) int32 on the device (no host round trip yet).  Sweeps with B2 at
    M == 2048 and B3 at M >= 4096 in the d == 2 tier, with `step_sweep`
    above it.  A column-sharded Xd is gathered onto its first device,
    reduced there and scattered back (see the module docstring)."""
    if isinstance(Xd, mesh_ctx.Sharded):
        X = mesh_ctx.gather(Xd, site=5)
        X, pivcol = rref_rows_device(X, p, nb)
        for t, b0, b1 in zip(Xd.shards, Xd.bounds()[:-1], Xd.bounds()[1:]):
            t.copy_(X[:, b0:b1])
        mesh_ctx.count(5, X[:, Xd.bounds()[1]:].numel() * X.element_size())
        return Xd, pivcol
    B, M = Xd.shape
    if B % _SB or M % _TW:
        raise ValueError(f"rref_rows_device needs B % {_SB} == 0 and "
                         f"M % {_TW} == 0, got {(B, M)}")
    nb = max(min(nb, B), _SB)
    while B % nb:
        nb //= 2
    nb -= nb % _SB
    if device_field(p).ndigits > 2:
        sweep = step_sweep
    else:
        sweep = row_sweep if M == _TW else row_sweep_tiles
    return _rref_rows(Xd, p, nb, sweep)


class CompactBasis:
    """Growing device-resident RREF basis over a fixed compacted width M.

    One preallocated (cap, M) buffer (pad rows zero, pivots parked at the
    dead column M-1).  Its storage type comes from the prime, as
    ReducedBasis's does (int16 holds every balanced value for
    p <= 65535, int32 above; the JAX package's default int16, ROADMAP
    C1, is not copied)."""

    def __init__(self, M: int, p: int, cap: int, device="cuda"):
        self.M = M
        self.p = p
        self.device = torch.device(device)
        self.dtype = storage_dtype(p)
        self.cap = max(cap, 1)
        self.mesh = mesh_ctx.current_mesh()
        # under a mesh Rbuf is column-sharded like the blocks it reduces
        if self.mesh is None:
            self.Rbuf = torch.zeros((self.cap, M), dtype=self.dtype,
                                    device=self.device)
        else:
            devs = mesh_ctx.shard_devices(self.mesh, 1)
            self.Rbuf = mesh_ctx.Sharded(
                [torch.zeros((self.cap, M // len(devs)), dtype=self.dtype,
                             device=d) for d in devs], 1, self.mesh)
        self.jbuf = torch.full((self.cap,), M - 1, dtype=torch.int64,
                               device=self.device)
        self.jpos_host: List[np.ndarray] = []
        self.count = 0
        self.nrows = 0

    def _coeffs(self, X, cols: np.ndarray) -> List[torch.Tensor]:
        """X[:, cols] on every column shard's device, X column-sharded
        (the collective of apply and add): each shard takes the columns
        it holds, one all-gather, and the pieces' order undone."""
        b = np.asarray(X.bounds())
        owner = np.searchsorted(b, cols, side="right") - 1
        order = np.argsort(owner, kind="stable")
        pieces = [t[:, torch.as_tensor(cols[order][owner[order] == j] - b[j],
                                       device=t.device)]
                  for j, t in enumerate(X.shards)]
        back = np.argsort(order)
        return [C[:, torch.as_tensor(back, device=C.device)]
                for C in mesh_ctx.all_gather_cols(pieces, X.mesh, site=5)]

    def apply(self, X):
        """Eliminate every basis pivot from X (B, M), in place.  One
        product per _CHUNK basis rows — exact because the basis is RREF."""
        if self.mesh is not None and self.count:
            jall = np.concatenate(self.jpos_host)
        for c0 in range(0, self.count, _CHUNK):
            c1 = min(self.count, c0 + _CHUNK)
            if self.mesh is None:
                C = X[:, self.jbuf[c0:c1]]
                X.copy_(_submod(X, matmul_digits(C, self.Rbuf[c0:c1],
                                                 self.p), self.p))
                continue
            for t, C, R in zip(X.shards, self._coeffs(X, jall[c0:c1]),
                               self.Rbuf.shards):
                t.copy_(_submod(t, matmul_digits(C, R[c0:c1], self.p),
                                self.p))
        return X

    def add(self, Rd, jpos: np.ndarray):
        """Append reduced rows (pivots at compacted columns jpos), after
        back-reducing the existing basis against them."""
        jpos = np.asarray(jpos, np.int64)
        jd = torch.as_tensor(jpos, device=self.device)
        for c0 in range(0, self.count, _CHUNK):
            c1 = min(self.count, c0 + _CHUNK)
            if self.mesh is None:
                Xc = self.Rbuf[c0:c1]
                Xc.copy_(_submod(Xc, matmul_digits(Xc[:, jd], Rd, self.p),
                                 self.p))
                continue
            Xc = self.Rbuf.map(lambda t: t[c0:c1])
            for t, C, R in zip(Xc.shards, self._coeffs(Xc, jpos),
                               Rd.shards):
                t.copy_(_submod(t, matmul_digits(C, R, self.p), self.p))
        Kp = int(Rd.shape[0])
        need = self.count + Kp
        if need > self.cap:                     # rare: bucket padding
            grow = max(need - self.cap, _CHUNK)
            self.Rbuf = mesh_ctx.smap(lambda t: torch.cat([t, torch.zeros(
                (grow, t.shape[1]), dtype=self.dtype, device=t.device)]),
                self.Rbuf)
            self.jbuf = torch.cat([self.jbuf, torch.full(
                (grow,), self.M - 1, dtype=torch.int64,
                device=self.device)])
            self.cap += grow
        if self.mesh is None:
            self.Rbuf[self.count:need] = Rd.to(self.dtype)
        else:
            for t, r in zip(self.Rbuf.shards, Rd.shards):
                t[self.count:need] = r.to(self.dtype)
        self.jbuf[self.count:need] = jd
        self.count = need
        self.jpos_host.append(jpos)
        self.nrows += int(jpos.size)

    def export(self):
        """(rows, jpos) of the whole basis: rows (count, M) device view
        (column-sharded under a mesh), jpos (count,) host (concatenated
        append order)."""
        if self.count == 0:
            return None, np.empty(0, np.int64)
        return (mesh_ctx.smap(lambda t: t[:self.count], self.Rbuf),
                np.concatenate(self.jpos_host))
