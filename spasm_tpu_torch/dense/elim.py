"""Blocked rank-revealing dense elimination over GF(p): the column-sweep
RREF / PLUQ of the dense finishers.

Port of spasm_tpu/dense/elim.py (see its docstring for the algebra):
columns are processed left to right in nb = 64 panels; a division-free
discovery sweep finds each panel's pivots (first not-yet-pivotal row
with a nonzero, per column); the panel's pivot minor W is inverted (RREF)
or LU-factored (LU) with one batched Fermat inversion; the panel update
is then two exact digit matmuls,
    U = W^-1 @ S[R, :],      S <- S - G @ U,   G = S[:, J] - I_at_pivots.
Two-level blocking: the panels update only their nblk = 512-column
block; the trailing matrix gets one composed update per block.

The latency-bound part of a panel step (discovery, W, its inverse or
forward factor, the unit-upper inverse) is kernel B4
(`dense/panel.py` + `csrc/panel.cu`) for a CUDA tensor in the d == 2
tier; a CPU tensor takes its plain version, `panel_steps` below.  Above
the d == 2 tier, `panel_steps` is the route on every device, as it is in
the JAX package (`use_pallas=False`: B4 holds int32 updates only).
Everything else is torch ops on `matmul_digits` (int8 `torch._int_mm`).

The port updates S in place where the JAX package rebuilt arrays, and
restricts each product to the columns it changes (the JAX package
computed full widths and masked them); the results are the same.  In
the d == 2 tier (p <= 65279) every step stays in int32; above it the
elementwise helpers form their products in int64 (`_small`, the one
place the tier is chosen) and store balanced int32.  Rows pad to a
quantum of 128 on every device (the JAX package pads to 32 off the
TPU); zero rows are inert, so outputs sliced to the input's rows are the
same.

Under an active mesh (parallel/context.py) the elimination is
column-sharded (`_eliminate`'s docstring): the padded width is a
multiple of 512 * cols, the pivot map is gathered once, and the device
entry points gather the pivot rows (and L's pivot columns) they return.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .modp import (_reduce31, device_field, dnorm64, matmul_digits, modinv,
                   mulmod)
from ..field import Field
from ..parallel import context as mesh_ctx
from ..profiling import annotate, phase

_NB = 64          # panel width (local sweep length)
_NBLK = 512       # column-block width of the composed trailing update
_ROWS_QUANTUM = 128


def _small(p: int) -> bool:
    """The d == 2 tier: every division-free update fits int32."""
    return device_field(p).ndigits == 2


def _mulsub(v, P, g, piv, p: int) -> torch.Tensor:
    """Balanced v*P - g*piv (outer-product form), int32 out.  d == 2:
    exact in int32, |v*P - g*piv| <= 2*(p/2)^2 < 2^31; above, in int64
    (< 2^63 for p <= 2^32 - 5).  The explicit casts matter: int16
    operands would multiply in int16 and overflow."""
    if not _small(p):
        x = (v.to(torch.int64) * P.to(torch.int64)
             - g.to(torch.int64) * piv.to(torch.int64))
        return dnorm64(x, p).to(torch.int32)
    x = (v.to(torch.int32) * P.to(torch.int32)
         - g.to(torch.int32) * piv.to(torch.int32))
    return _reduce31(x, p)


def _submod(A, B, p: int) -> torch.Tensor:
    """Balanced A - B of balanced operands (one conditional correction;
    the difference in int64 above the d == 2 tier, where it may pass
    2^31)."""
    wide = not _small(p)
    dt = torch.int64 if wide else torch.int32
    x = A.to(dt) - B.to(dt)
    half = (p - 1) >> 1
    x = torch.where(x > half, x - p, x)
    x = torch.where(x < -half, x + p, x)
    return x.to(torch.int32) if wide else x


def _scale_rows(c, M, p: int) -> torch.Tensor:
    """Balanced diag(c) @ M, int32 out."""
    if not _small(p):
        return mulmod(c[:, None], M, p).to(torch.int32)
    return _reduce31(c[:, None].to(torch.int32) * M.to(torch.int32), p)


def _size_bucket(x: int, quantum: int) -> int:
    """Round up to a power of two (<= 1024) or to a multiple of 512."""
    x = max(x, quantum)
    if x <= 1024:
        b = quantum
        while b < x:
            b <<= 1
        return b
    return -(-x // 512) * 512


class _Pivots(NamedTuple):
    lrows: torch.Tensor    # (nb,) int32 pivot row per slot (-1 if none)
    lhas: torch.Tensor     # (nb,) bool slot validity
    is_piv: torch.Tensor   # (n,) bool updated pivot-row mask


def _discovery_sweep(P: torch.Tensor, is_piv: torch.Tensor,
                     p: int) -> _Pivots:
    """Division-free pivot discovery on an (n, nb) panel (positions only):
    the updates scale rows by the running pivot value, which keeps zero
    patterns exactly, so the pivots are those of the classical sweep.
    No host sync: every step stays on P's device."""
    n, nb = P.shape
    dev = P.device
    iota = torch.arange(n, device=dev)
    P = P.to(torch.int32)
    lrows = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    lhas = torch.zeros(nb, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    for t in range(nb):
        col = P[:, t]
        avail = ~is_piv & (col != 0)
        has = avail.any()
        # first available row; index_select keeps r on the device
        r = torch.argmax(avail.to(torch.int32)).view(1)
        prow = P.index_select(0, r)                       # (1, nb)
        v = torch.where(has, prow[0, t], one)
        g = torch.where(avail & (iota != r), col, 0)
        P = _mulsub(v, P, g[:, None], prow, p)
        lrows[t] = torch.where(has, r[0].to(torch.int32), -one)
        lhas[t] = has
        is_piv = is_piv | ((iota == r) & has)
    return _Pivots(lrows, lhas, is_piv)


def _jordan_inverse(W: torch.Tensor, p: int) -> torch.Tensor:
    """W^-1 mod p by division-free Gauss-Jordan with diagonal pivots (every
    leading principal minor of W is nonsingular for a pivot minor), then
    one batched Fermat inversion of the accumulated diagonal."""
    nb = W.shape[0]
    dev = W.device
    M = torch.cat([W.to(torch.int32),
                   torch.eye(nb, dtype=torch.int32, device=dev)], dim=1)
    for t in range(nb):
        v = M[t, t]
        g = M[:, t].clone()
        g[t] = _submod(v, torch.ones_like(v), p)
        M = _mulsub(v, M, g[:, None], M[t][None, :], p)
    ar = torch.arange(nb, device=dev)
    dinv = dnorm64(modinv(M[ar, ar], p), p)
    return _scale_rows(dinv, M[:, nb:], p)


def _forward_factor(W: torch.Tensor, p: int):
    """Division-free forward elimination of [W | I] (rows below the
    diagonal only).  Returns (Zlu, Vup): Zlu = D^-1 Lambda^-1 (Zlu @ S[R]
    are the unit-pivot LU rows) and Vup = D^-1 Omega (unit upper; W =
    Lambda Omega, D = diag(Omega))."""
    nb = W.shape[0]
    dev = W.device
    iota = torch.arange(nb, device=dev)
    M = torch.cat([W.to(torch.int32),
                   torch.eye(nb, dtype=torch.int32, device=dev)], dim=1)
    for t in range(nb):
        v = M[t, t]
        below = iota > t
        g = torch.where(below, M[:, t], 0)
        Mnew = _mulsub(v, M, g[:, None], M[t][None, :], p)
        M = torch.where(below[:, None], Mnew, M)
    dinv = dnorm64(modinv(M[iota, iota], p), p)
    return _scale_rows(dinv, M[:, nb:], p), _scale_rows(dinv, M[:, :nb], p)


def _unit_upper_inverse_small(V: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of a unit upper-triangular (nb, nb) matrix mod p, row by
    row from the bottom (each row sum <= nb * p/2 stays in int32 in the
    d == 2 tier; above it the products and sums are int64)."""
    nb = V.shape[0]
    Vinv = torch.zeros_like(V, dtype=torch.int32)
    small = _small(p)
    for i in range(nb - 1, -1, -1):
        if small:
            terms = _reduce31(V[i, :, None].to(torch.int32) * Vinv, p)
            row = _reduce31(-terms.sum(dim=0, dtype=torch.int32), p)
            row[i] += 1
            Vinv[i] = _reduce31(row, p)
        else:
            terms = mulmod(V[i, :, None], Vinv, p)
            row = dnorm64(-terms.sum(dim=0), p)
            row[i] += 1
            Vinv[i] = dnorm64(row, p).to(torch.int32)
    return Vinv


@annotate("panel_steps")
def panel_steps(P0: torch.Tensor, is_piv: torch.Tensor, p: int, nb: int,
                rref: bool):
    """One panel's pivots and pivot-minor factors in torch ops: the JAX
    package's `use_pallas=False` route (`_discovery_sweep`, W assembly,
    `_jordan_inverse` / `_forward_factor` + `_unit_upper_inverse_small`),
    with the outputs of kernel B4 (dense/panel.py, which takes it as its
    plain version): (lrows, lhas, is_piv', Z) in RREF mode, (lrows,
    lhas, is_piv', Z, Vinv) in LU mode.  Above the d == 2 tier this is
    the route on every device, one `spasm/panel_steps` range a panel."""
    piv = _discovery_sweep(P0, is_piv, p)
    lsafe = torch.where(piv.lhas, piv.lrows, 0).to(torch.int64)
    both = piv.lhas[:, None] & piv.lhas[None, :]
    W = torch.where(both, P0[lsafe], torch.eye(nb, dtype=torch.int32,
                                               device=P0.device))
    if rref:
        return piv.lrows, piv.lhas, piv.is_piv, _jordan_inverse(W, p)
    Zlu, Vup = _forward_factor(W, p)
    return (piv.lrows, piv.lhas, piv.is_piv, Zlu,
            _unit_upper_inverse_small(Vup, p))


def _panel_step(S: torch.Tensor, j0: int, is_piv: torch.Tensor,
                L, p: int, nb: int, rref: bool, panel_pivots):
    """One panel update of the column block S (n, w) at local column j0,
    in place.  Returns (lrows, lhas, is_piv').  In LU mode, L (n, w)
    receives the multiplier columns at [j0, j0 + nb)."""
    P0 = S[:, j0:j0 + nb]
    out = panel_pivots(P0, is_piv, p, nb, rref)
    lrows, lhas, is_piv2 = out[0], out[1], out[2]
    slot = torch.arange(nb, device=S.device)
    lrows_safe = torch.where(lhas, lrows, 0).to(torch.int64)
    # only columns >= j0 change: U is zero left of the panel
    rows0 = torch.where(lhas[:, None], S[lrows_safe, j0:], 0)    # (nb, w')
    minus = torch.where(lhas, -1, 0).to(torch.int32)
    U = matmul_digits(out[3], rows0, p)
    U = torch.where(lhas[:, None], U, 0)
    if rref:
        G = torch.where(lhas[None, :], P0, 0)
    else:
        # multipliers of every not-yet-pivotal row (the panel's own pivot
        # rows included: ell[r_t] = (Lambda D)[t, :])
        Cf = torch.where(~is_piv[:, None] & lhas[None, :], P0, 0)
        G = torch.where(lhas[None, :], matmul_digits(Cf, out[4], p), 0)
        L[:, j0:j0 + nb] = G
    # G - I at the pivot slots: pivot row r_t lands exactly on U[t].  An
    # empty slot adds 0 at index 0; accumulate makes the duplicates exact.
    G = G.index_put((lrows_safe, slot), minus, accumulate=True)
    S[:, j0:] = _submod(S[:, j0:], matmul_digits(G, U, p), p)
    return lrows, lhas, is_piv2


def _eliminate(S, p: int, rref: bool, nb: int = _NB, nblk: int = 0):
    """Full blocked elimination of S (n, m) int32 balanced, m % nb == 0,
    in place.  Returns (S, pivrow_of_col (m,) int32, is_piv (n,) bool,
    L (n, m) int32 in LU mode, else None).  In LU mode, L's slot column t
    of panel q holds the multiplier column of local step t.

    S may be column-sharded (mesh_ctx.Sharded, axis 1, each shard a whole
    number of nblk-column blocks: right-looking column-block elimination,
    the JAX package's P(None, 'cols')).  Block qb's panels and trailing
    inverse run on the shard that owns it; the owner broadcasts lrows,
    lhas, is_piv, Z and G - I (n x nblk) to the shards right of it, and
    each of those forms its own rows of U and updates its own columns.  L
    is sharded as S (a block's slot columns stay with its owner), and
    pivrow_of_col comes back sharded the same way (axis 0 of its own)."""
    from .panel import panel_pivots
    # B4 holds the d == 2 tier; above it the panels take the torch route
    pivots = panel_pivots if _small(p) else panel_steps
    sharded = isinstance(S, mesh_ctx.Sharded)
    shards = S.shards if sharded else [S]
    n, w = shards[0].shape
    if nblk <= 0:
        nblk = _NBLK
    nblk = min(nblk, w)
    if w % nblk != 0:        # padded sizes are 2^k or 512q: only tiny m
        nblk = nb
    per = w // nblk                    # blocks per shard
    nblocks = per * len(shards)
    Ls = None if rref else [torch.zeros((n, w), dtype=torch.int32,
                                        device=t.device) for t in shards]
    pivrows = [torch.full((w,), -1, dtype=torch.int32, device=t.device)
               for t in shards]
    # the latest pivot-row mask on each shard (it rides the broadcasts)
    piv_at = [torch.zeros(n, dtype=torch.bool, device=shards[0].device)]
    piv_at += [None] * (len(shards) - 1)
    for qb in range(nblocks):
        own, b = divmod(qb, per)
        j0 = b * nblk
        j1 = j0 + nblk
        S0 = shards[own]
        dev = S0.device
        is_piv = piv_at[own]
        P_pre = S0[:, j0:j1].clone()
        B = S0[:, j0:j1]                   # the panels update it in place
        Lb = None if rref else Ls[own][:, j0:j1]
        lrows = torch.full((nblk,), -1, dtype=torch.int32, device=dev)
        lhas = torch.zeros(nblk, dtype=torch.bool, device=dev)
        for jl in range(0, nblk, nb):
            lr, lh, is_piv = _panel_step(B, jl, is_piv, Lb, p, nb, rref,
                                         pivots)
            lrows[jl:jl + nb] = lr
            lhas[jl:jl + nb] = lh
        piv_at[own] = is_piv
        pivrows[own][j0:j1] = torch.where(lhas, lrows, -1)
        if qb == nblocks - 1:
            break
        # one composed update of the trailing columns for the whole block;
        # its nblk-step inverse is a loop of small torch ops
        lsafe = torch.where(lhas, lrows, 0).to(torch.int64)
        both = lhas[:, None] & lhas[None, :]
        W = torch.where(both, P_pre[lsafe],
                        torch.eye(nblk, dtype=torch.int32, device=dev))
        with phase("trailing_inverse"):
            if rref:
                Z = _jordan_inverse(W, p)
                G = torch.where(lhas[None, :], P_pre, 0)
            else:
                Z, _ = _forward_factor(W, p)
                G = torch.where(lhas[None, :], Lb, 0)
        # G - I at the pivot slots
        G = G.index_put((lsafe, torch.arange(nblk, device=dev)),
                        torch.where(lhas, -1, 0).to(torch.int32),
                        accumulate=True)
        right = [t.device for t in shards[own + 1:]]
        sent = [mesh_ctx.broadcast(x, right, site=3)
                for x in (lrows, lhas, is_piv, Z, G)] if right else []
        for t in range(own, len(shards)):
            if t == own:
                c0, lr_t, lh_t, Z_t, G_t = j1, lrows, lhas, Z, G
            else:
                c0 = 0
                lr_t, lh_t, piv_at[t], Z_t, G_t = (x[t - own - 1]
                                                  for x in sent)
            St = shards[t]
            if c0 == w:                    # the owner's last block
                continue
            with phase("trailing_update"):
                ls_t = torch.where(lh_t, lr_t, 0).to(torch.int64)
                rows_cur = torch.where(lh_t[:, None], St[ls_t, c0:], 0)
                U = torch.where(lh_t[:, None],
                                matmul_digits(Z_t, rows_cur, p), 0)
                St[:, c0:] = _submod(St[:, c0:], matmul_digits(G_t, U, p),
                                     p)
    if not sharded:
        return S, pivrows[0], piv_at[0], None if rref else Ls[0]
    return (S, mesh_ctx.Sharded(pivrows, 0, S.mesh), piv_at[own],
            None if rref else mesh_ctx.Sharded(Ls, 1, S.mesh))


def _col_bucket(m: int, nb: int) -> int:
    """Padded column count: _size_bucket(m, nb), and under an active
    mesh with cols > 1 a multiple of nblk * cols, so that every column
    shard holds whole 512-column blocks (zero columns take no pivot)."""
    mp = _size_bucket(max(m, 1), nb)
    c = mesh_ctx.col_quantum()
    if c > 1:
        q = _NBLK * c
        mp = -(-mp // q) * q
    return mp


def _pad(S: torch.Tensor, nb: int):
    """Zero-pad S to (row bucket of 128, column bucket of nb); a new
    tensor either way (the elimination runs in place).  Under an active
    mesh the padded S is placed column-sharded (site 3)."""
    n, m = S.shape
    out = torch.zeros((_size_bucket(max(n, 1), _ROWS_QUANTUM),
                       _col_bucket(m, nb)), dtype=torch.int32,
                      device=S.device)
    out[:n, :m] = S
    return mesh_ctx.shard_cols(out, site=3)


def _run(S: np.ndarray, p: int, rref: bool, nb: int, device):
    return _eliminate(_pad(torch.as_tensor(
        np.ascontiguousarray(S, np.int32), device=torch.device(device)),
        nb), p, rref, nb)


def _pivot_rows(Sf, rows: torch.Tensor, m: int) -> torch.Tensor:
    """Sf[rows, :m] on rows' device; of a column-sharded Sf, each shard
    selects the rows, then one gather."""
    if isinstance(Sf, mesh_ctx.Sharded):
        Sf = mesh_ctx.gather(Sf.map(lambda t: t[rows.to(t.device)]),
                             site=3)
        rows = torch.arange(rows.numel(), device=Sf.device)
    return Sf[rows, :m]


@annotate("dense_rref")
def dense_rref_device(Xd: torch.Tensor, p: int, nb: int = _NB):
    """Device-resident RREF of Xd (n, m), on Xd's device.  Returns (Rd,
    pivcols): Rd the (rank, m) reduced pivot rows on the device (ordered
    by pivot column, unit pivots), pivcols the ascending host pivot
    columns.  Only the (m,) pivot-row map crosses to the host.  Under an
    active mesh the elimination runs column-sharded and Rd is gathered
    onto Xd's device."""
    n, m = Xd.shape
    Sf, pivrow_of_col, _, _ = _eliminate(_pad(Xd, nb), p, True, nb)
    with phase("pivmap_read"):
        pivrow = mesh_ctx.gather(pivrow_of_col, site=3).cpu().numpy()[:m]
    pivcols = np.nonzero(pivrow >= 0)[0]
    if not pivcols.size:
        return (torch.zeros((0, m), dtype=torch.int32, device=Xd.device),
                pivcols.astype(np.int64))
    rows = torch.as_tensor(pivrow[pivcols].astype(np.int64),
                           device=Xd.device)
    return _pivot_rows(Sf, rows, m), pivcols.astype(np.int64)


def _normalize_rows(Ud: torch.Tensor, pv: torch.Tensor,
                    p: int) -> torch.Tensor:
    return _scale_rows(dnorm64(modinv(pv, p), p), Ud, p)


@annotate("dense_lu")
def dense_lu_device(Xd: torch.Tensor, p: int, nb: int = _NB):
    """Device-resident column-pivoted LU of Xd (n, m), on Xd's device.

    Returns (prows, pivcols, Ld, Ud): prows / pivcols host (rank,) int64;
    Ld (n, rank) device multiplier columns and Ud (rank, m) device
    unit-pivot rows with Xd == Ld @ Ud mod p (the pivot values live in
    Ld, as in dense_lu).  Only the (m,) pivot map crosses to the host."""
    n, m = Xd.shape
    dev = Xd.device
    Sf, pivrow_of_col, _, Lslots = _eliminate(_pad(Xd, nb), p, False, nb)
    with phase("pivmap_read"):
        pivrow = mesh_ctx.gather(pivrow_of_col, site=3).cpu().numpy()[:m]
    pivcols = np.nonzero(pivrow >= 0)[0].astype(np.int64)
    if not pivcols.size:
        return (np.empty(0, np.int64), pivcols,
                torch.zeros((n, 0), dtype=torch.int32, device=dev),
                torch.zeros((0, m), dtype=torch.int32, device=dev))
    prows = pivrow[pivcols].astype(np.int64)
    Urows = _pivot_rows(Sf, torch.as_tensor(prows, device=dev), m)
    cols_d = torch.as_tensor(pivcols, device=dev)
    Ud = _normalize_rows(Urows, Urows[torch.arange(pivcols.size,
                                                   device=dev), cols_d], p)
    return prows, pivcols, _pivot_cols(Lslots, pivcols, n), Ud


def _pivot_cols(L, pivcols: np.ndarray, n: int) -> torch.Tensor:
    """L[:n, pivcols] on the first device; of a column-sharded L, each
    shard selects the pivot columns it owns (ascending, so the gather's
    shard order keeps pivcols' order)."""
    if not isinstance(L, mesh_ctx.Sharded):
        return L[:n, torch.as_tensor(pivcols, device=L.device)]
    b = L.bounds()
    return mesh_ctx.gather(mesh_ctx.Sharded(
        [t[:n, torch.as_tensor(pivcols[(pivcols >= b0) & (pivcols < b1)]
                               - b0, device=t.device)]
         for t, b0, b1 in zip(L.shards, b[:-1], b[1:])], 1, L.mesh), site=3)


# Below this many elements the numpy sweep beats device dispatch.
_HOST_LIMIT = 1 << 16


def _norm_np(x: np.ndarray, p: int) -> np.ndarray:
    r = x % p
    return np.where(r > p // 2, r - p, r)


def _sweep_np(S: np.ndarray, p: int, rref: bool):
    """Host elimination with the device's pivot choices (first
    not-yet-pivotal row per column, no swapping)."""
    A = np.ascontiguousarray(S, np.int64)
    n, m = A.shape
    is_piv = np.zeros(n, dtype=bool)
    prows, pcols = [], []
    L = np.zeros((n, min(n, m)), np.int64) if not rref else None
    for j in range(m):
        col = A[:, j]
        avail = (~is_piv) & (col != 0)
        if not avail.any():
            continue
        r = int(np.argmax(avail))
        pivval = int(A[r, j])
        inv = pow(pivval, -1, p)
        inv = inv - p if inv > p // 2 else inv
        u = _norm_np(A[r] * inv, p)
        if rref:
            g = col.copy()
            g[r] = pivval - 1
            A = _norm_np(A - np.outer(g, u), p)
        else:
            g = np.where(avail, col, 0)
            g[r] = 0
            A = _norm_np(A - np.outer(g, u), p)
            L[:, len(prows)] = g
            L[r, len(prows)] = pivval
        prows.append(r)
        pcols.append(j)
        is_piv[r] = True
    return A, np.asarray(prows, np.int64), np.asarray(pcols, np.int64), L


def _on_host(S: np.ndarray, force) -> bool:
    return force != "device" and (force == "host" or S.size <= _HOST_LIMIT)


def dense_rref(S: np.ndarray, p: int, nb: int = _NB, force: str = None,
               device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """RREF with column pivoting of S mod p (numpy in and out): R (rank,
    m) fully reduced rows with pivot 1 at pivcols[i], ordered by pivot
    column; pivcols (rank,) ascending.  Above _HOST_LIMIT elements the
    elimination runs on `device`."""
    n, m = S.shape
    if _on_host(S, force):
        A, prows, pivcols, _ = _sweep_np(S, p, True)
        R = A[prows].astype(np.int32) if prows.size else \
            np.empty((0, m), np.int32)
        return R, pivcols
    Sf, pivrow_of_col, _, _ = _run(S, p, True, nb, device)
    pivrow_of_col = mesh_ctx.gather(pivrow_of_col, "cpu", 3).numpy()[:m]
    pivcols = np.nonzero(pivrow_of_col >= 0)[0]
    rows = pivrow_of_col[pivcols]
    R = mesh_ctx.gather(Sf, "cpu", 3).numpy()[rows][:, :m] \
        if pivcols.size else np.empty((0, m), np.int32)
    return R, pivcols.astype(np.int64)


def dense_lu(S: np.ndarray, p: int, nb: int = _NB, force: str = None,
             device="cuda"):
    """Column-pivoted PLUQ-style factorization of S mod p.  Returns (rank,
    prows, pivcols, L, Urows) with S == L @ Urows mod p: prows / pivcols
    (rank,) in pivot order, L (n, rank), Urows (rank, m) unit-pivot rows.
    Above _HOST_LIMIT elements the elimination runs on `device`."""
    n, m = S.shape
    F = Field(p)
    if _on_host(S, force):
        A, prows, pivcols, L = _sweep_np(S, p, False)
        rank = prows.size
        if rank:
            invs = F.inverse_array(A[prows, pivcols]).astype(np.int64)
            Urows = F.narray(A[prows] * invs[:, None])
            Lc = F.narray(L[:, :rank])
        else:
            Urows = np.empty((0, m), np.int32)
            Lc = np.empty((n, 0), np.int32)
        return rank, prows, pivcols, Lc, Urows
    Sf, pivrow_of_col, _, Lslots = _run(S, p, False, nb, device)
    pivrow_of_col = mesh_ctx.gather(pivrow_of_col, "cpu", 3).numpy()[:m]
    pivcols = np.nonzero(pivrow_of_col >= 0)[0]
    rows = pivrow_of_col[pivcols]
    rank = pivcols.size
    if rank:
        Sf = mesh_ctx.gather(Sf, "cpu", 3).numpy()
        inv = F.inverse_array(Sf[rows, pivcols].astype(np.int64))
        Urows = F.narray(Sf[rows][:, :m].astype(np.int64)
                         * inv.astype(np.int64)[:, None])
        L = mesh_ctx.gather(Lslots, "cpu", 3).numpy()[:n, pivcols]
    else:
        Urows = np.empty((0, m), np.int32)
        L = np.empty((n, 0), np.int32)
    return rank, rows.astype(np.int64), pivcols.astype(np.int64), L, Urows


def dense_rank(S: np.ndarray, p: int, nb: int = _NB, force: str = None,
               device="cuda") -> int:
    """Rank of a dense balanced int32 matrix mod p."""
    n, m = S.shape
    if n == 0 or m == 0:
        return 0
    if _on_host(S, force):
        _, prows, _, _ = _sweep_np(S, p, True)
        return int(prows.size)
    _, pivrow_of_col, _, _ = _run(S, p, True, nb, device)
    return int((mesh_ctx.gather(pivrow_of_col, "cpu", 3)[:m] >= 0).sum())
