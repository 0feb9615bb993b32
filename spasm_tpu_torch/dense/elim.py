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
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .modp import (_reduce31, device_field, dnorm64, matmul_digits, modinv,
                   mulmod)
from ..field import Field
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


def panel_steps(P0: torch.Tensor, is_piv: torch.Tensor, p: int, nb: int,
                rref: bool):
    """One panel's pivots and pivot-minor factors in torch ops: the JAX
    package's `use_pallas=False` route (`_discovery_sweep`, W assembly,
    `_jordan_inverse` / `_forward_factor` + `_unit_upper_inverse_small`),
    with the outputs of kernel B4 (dense/panel.py, which takes it as its
    plain version): (lrows, lhas, is_piv', Z) in RREF mode, (lrows,
    lhas, is_piv', Z, Vinv) in LU mode.  Above the d == 2 tier this is
    the route on every device."""
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


def _eliminate(S: torch.Tensor, p: int, rref: bool, nb: int = _NB,
               nblk: int = 0):
    """Full blocked elimination of S (n, m) int32 balanced, m % nb == 0,
    in place.  Returns (S, pivrow_of_col (m,) int32, is_piv (n,) bool,
    L (n, m) int32 in LU mode, else None).  In LU mode, L's slot column t
    of panel q holds the multiplier column of local step t."""
    from .panel import panel_pivots
    # B4 holds the d == 2 tier; above it the panels take the torch route
    pivots = panel_pivots if _small(p) else panel_steps
    n, m = S.shape
    dev = S.device
    if nblk <= 0:
        nblk = _NBLK
    nblk = min(nblk, m)
    if m % nblk != 0:        # padded sizes are 2^k or 512q: only tiny m
        nblk = nb
    nblocks = m // nblk
    L = None if rref else torch.zeros((n, m), dtype=torch.int32, device=dev)
    pivrow_of_col = torch.full((m,), -1, dtype=torch.int32, device=dev)
    is_piv = torch.zeros(n, dtype=torch.bool, device=dev)
    eyeb = torch.eye(nblk, dtype=torch.int32, device=dev)
    slot = torch.arange(nblk, device=dev)
    for qb in range(nblocks):
        j0 = qb * nblk
        j1 = j0 + nblk
        P_pre = S[:, j0:j1].clone()
        B = S[:, j0:j1]                    # the panels update it in place
        Lb = None if rref else L[:, j0:j1]
        lrows = torch.full((nblk,), -1, dtype=torch.int32, device=dev)
        lhas = torch.zeros(nblk, dtype=torch.bool, device=dev)
        for jl in range(0, nblk, nb):
            lr, lh, is_piv = _panel_step(B, jl, is_piv, Lb, p, nb, rref,
                                         pivots)
            lrows[jl:jl + nb] = lr
            lhas[jl:jl + nb] = lh
        pivrow_of_col[j0:j1] = torch.where(lhas, lrows, -1)
        if qb == nblocks - 1:
            break
        # one composed update of the trailing columns for the whole block;
        # its nblk-step inverse is a loop of small torch ops
        lsafe = torch.where(lhas, lrows, 0).to(torch.int64)
        both = lhas[:, None] & lhas[None, :]
        W = torch.where(both, P_pre[lsafe], eyeb)
        rows_cur = torch.where(lhas[:, None], S[lsafe, j1:], 0)
        with phase("trailing_inverse"):
            if rref:
                Z = _jordan_inverse(W, p)
                G = torch.where(lhas[None, :], P_pre, 0)
            else:
                Z, _ = _forward_factor(W, p)
                G = torch.where(lhas[None, :], Lb, 0)
        U = torch.where(lhas[:, None], matmul_digits(Z, rows_cur, p), 0)
        G = G.index_put((lsafe, slot), torch.where(lhas, -1, 0).to(
            torch.int32), accumulate=True)
        S[:, j1:] = _submod(S[:, j1:], matmul_digits(G, U, p), p)
    return S, pivrow_of_col, is_piv, L


def _pad(S: torch.Tensor, nb: int) -> torch.Tensor:
    """Zero-pad S to (row bucket of 128, column bucket of nb); a new
    tensor either way (the elimination runs in place)."""
    n, m = S.shape
    mp = _size_bucket(max(m, 1), nb)
    np_ = _size_bucket(max(n, 1), _ROWS_QUANTUM)
    out = torch.zeros((np_, mp), dtype=torch.int32, device=S.device)
    out[:n, :m] = S
    return out


def _run(S: np.ndarray, p: int, rref: bool, nb: int, device):
    return _eliminate(_pad(torch.as_tensor(
        np.ascontiguousarray(S, np.int32), device=torch.device(device)),
        nb), p, rref, nb)


@annotate("dense_rref")
def dense_rref_device(Xd: torch.Tensor, p: int, nb: int = _NB):
    """Device-resident RREF of Xd (n, m), on Xd's device.  Returns (Rd,
    pivcols): Rd the (rank, m) reduced pivot rows on the device (ordered
    by pivot column, unit pivots), pivcols the ascending host pivot
    columns.  Only the (m,) pivot-row map crosses to the host."""
    n, m = Xd.shape
    Sf, pivrow_of_col, _, _ = _eliminate(_pad(Xd, nb), p, True, nb)
    pivrow = pivrow_of_col.cpu().numpy()[:m]
    pivcols = np.nonzero(pivrow >= 0)[0]
    if not pivcols.size:
        return (torch.zeros((0, m), dtype=torch.int32, device=Xd.device),
                pivcols.astype(np.int64))
    rows = torch.as_tensor(pivrow[pivcols].astype(np.int64),
                           device=Xd.device)
    return Sf[rows, :m], pivcols.astype(np.int64)


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
    pivrow = pivrow_of_col.cpu().numpy()[:m]
    pivcols = np.nonzero(pivrow >= 0)[0].astype(np.int64)
    if not pivcols.size:
        return (np.empty(0, np.int64), pivcols,
                torch.zeros((n, 0), dtype=torch.int32, device=dev),
                torch.zeros((0, m), dtype=torch.int32, device=dev))
    prows = pivrow[pivcols].astype(np.int64)
    rows_d = torch.as_tensor(prows, device=dev)
    cols_d = torch.as_tensor(pivcols, device=dev)
    Ud = _normalize_rows(Sf[rows_d, :m], Sf[rows_d, cols_d], p)
    return prows, pivcols, Lslots[:n, cols_d], Ud


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
    pivrow_of_col = pivrow_of_col.cpu().numpy()[:m]
    pivcols = np.nonzero(pivrow_of_col >= 0)[0]
    rows = pivrow_of_col[pivcols]
    R = Sf.cpu().numpy()[rows][:, :m] if pivcols.size else \
        np.empty((0, m), np.int32)
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
    pivrow_of_col = pivrow_of_col.cpu().numpy()[:m]
    pivcols = np.nonzero(pivrow_of_col >= 0)[0]
    rows = pivrow_of_col[pivcols]
    rank = pivcols.size
    if rank:
        Sf = Sf.cpu().numpy()
        inv = F.inverse_array(Sf[rows, pivcols].astype(np.int64))
        Urows = F.narray(Sf[rows][:, :m].astype(np.int64)
                         * inv.astype(np.int64)[:, None])
        L = Lslots.cpu().numpy()[:n, pivcols]
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
    return int((pivrow_of_col.cpu()[:m] >= 0).sum())
