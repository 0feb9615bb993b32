"""The yardstick of the kernel roofline shares: the published peaks of
one NVIDIA H100 SXM (dense, at its 700 W limit) and the bytes and
operations each kernel needs for one call, computed from that call's
shapes and data.  Each input byte is counted read once and each output
byte written once, whatever the kernel reads again.

The formulas for B1 and B4 are those of the repository's chip_smoke.py
(`b1_line`, `_b4_ops`), copied here so that they cannot move with the
program; B4's discovery count replays the panels in plain torch, as
`_b4_ops` does.
"""
from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # HBM3
CORE_OPS_PER_S = 67e12           # FP32 / INT32 outside the tensor cores
INT8_OPS_PER_S = 1979e12         # int8 tensor cores, dense


def least_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def b1_cost(rows, ref_ptr, refs, coef, bounds, M: int, elem: int):
    """(bytes, ops) of one B1 launch: every row it writes read and
    written once, every row it references read once, its int32 schedule
    (bounds, rows, ref_ptr, refs, coef) read once; a product and a sum
    per reference and column."""
    nrefs = int(np.asarray(ref_ptr)[-1])
    rows = np.asarray(rows)
    refs = np.asarray(refs)[:nrefs]
    touched = np.union1d(rows, refs).size + rows.size
    sched = 4 * (len(bounds) + rows.size + len(ref_ptr) + 2 * nrefs)
    return touched * M * elem + sched, 2 * nrefs * M


def b4_costs(panels, nb: int = 64, batch: int = 64):
    """[(bytes, ops)] of B4 launches, one per (P0, is_piv, p, rref) on an
    (n, nb) panel: the panel and the pivot mask read, the mask, pivot rows
    and flags written, Z (and Vinv in LU mode) written; 3 operations per
    updated element: the discovery updates of the available rows with a
    nonzero in the step's column (counted on each panel's own data, by
    replaying the discovery: the division-free update v * P - g * row mod
    p), the nb steps on [W | I], the diagonal scaling and, in LU mode,
    the unit-upper inverse.  Panels of one shape replay together, on the
    device, with no host sync inside."""
    out = [None] * len(panels)
    groups = {}
    for i, (P0, _, p, rref) in enumerate(panels):
        groups.setdefault((tuple(P0.shape), p, rref), []).append(i)
    for (shape, p, rref), idx in groups.items():
        n = shape[0]
        fixed = sum(3 * ((nb - 1) if rref else (nb - 1 - t)) * 2 * nb
                    for t in range(nb)) + nb * nb * (1 if rref else 2)
        if not rref:
            fixed += sum(2 * (nb - 1 - i) * nb for i in range(nb))
        nbytes = n * nb * 4 + 2 * n + nb * 5 + nb * nb * 4 * (1 if rref
                                                               else 2)
        for c in range(0, len(idx), batch):
            part = idx[c:c + batch]
            ops = _discovery_ops([panels[i][0] for i in part],
                                 [panels[i][1] for i in part], p, nb)
            for i, o in zip(part, ops):
                out[i] = (nbytes, o + fixed)
    return out


def _discovery_ops(P0s, pivs, p: int, nb: int):
    P = torch.stack(P0s).to(torch.int64)           # (b, n, nb)
    piv = torch.stack(pivs).clone()                # (b, n)
    b, n = piv.shape
    rows = torch.arange(n, device=P.device)[None, :]
    at = torch.arange(b, device=P.device)
    ops = torch.zeros(b, dtype=torch.int64, device=P.device)
    for t in range(nb):
        col = P[:, :, t]
        avail = ~piv & (col != 0)
        has = avail.any(1)
        r = torch.argmax(avail.to(torch.int32), 1)
        g = torch.where(avail & (rows != r[:, None]), col, 0)
        ops += has * 3 * (g != 0).sum(1) * (nb - 1 - t)
        step = torch.remainder(col[at, r][:, None, None] * P
                               - g[:, :, None] * P[at, r][:, None, :], p)
        P = torch.where(has[:, None, None], step, P)
        piv = piv | (has[:, None] & (rows == r[:, None]))
    return ops.tolist()


def int_mm_cost(shapes):
    """(bytes, ops) of an int8 (m, k) @ (k, n) -> int32 (m, n) product
    (the program's `_mm8`, before it pads to cuBLASLt's shapes)."""
    (m, k), (_, n) = shapes[0], shapes[1]
    return m * k + k * n + 4 * m * n, 2 * m * n * k
