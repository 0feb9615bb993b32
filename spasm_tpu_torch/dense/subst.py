"""Reduced-basis substitution sweep: kernel B1 and its plain version.

Port of spasm_tpu/dense/subst_pallas.py.  For every basis row k with
references, in topological order,

    R[k] <- R[k] - sum_s coef[s] * R[refs[s]]   (mod p, balanced)

where R[k] already holds row k's scattered free entries.  The rows come
in waves (the topological groups of the U rows): rows of one wave never
reference each other and only reference rows of earlier waves, so each
wave is one data-parallel step.  The CUDA kernel (csrc/subst.cu) is
one launch per call: its blocks own column chunks and each walks every
wave, since a column of R[k] depends only on the same column of the rows
k references.  R's storage follows the prime (as `ReducedBasis` stores
it): int16 for p <= 65535, where the kernel sums in int32, and int32
above, where a kernel of its own ("B1 wide", counted apart) forms its
products in 64 bits on a grid the card holds at once (`wide_plan`).  The
plain version runs the wave loop as torch ops (gather, int64 sum, mod).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _cuda
from .modp import dnorm64, storage_dtype

_KMAX = 16
SUBST_COLS = 64              # kernel B1's columns per block (csrc kCols)
_PLAIN_BUDGET = 1 << 26      # elements of one plain-version gather


def nred_for(p: int) -> int:
    """Products per int32 partial sum: nred * (p//2)^2 < 2^31 - p."""
    return max(1, min(_KMAX, ((1 << 31) - p) // max((p // 2) ** 2, 1)))


def nred_wide(p: int, cmax: Optional[int] = None) -> int:
    """Products per int64 partial sum of the int32-storage kernel, for
    coefficients of magnitude at most cmax (default p // 2: any balanced
    value): nred * cmax * (p//2) <= 2^63 - 2p, at most 16 (16 at d = 3,
    2 at p = 2^32 - 5 by default; 16 for the +-1 entries of a boundary
    map), so a partial sum, which starts within p/2 + 2560 of 0
    (csrc/modp.cuh FpWide.part), stays within 2^63 - p, where FpWide
    reduces."""
    c = p // 2 if cmax is None else cmax
    return max(1, min(_KMAX, ((1 << 63) - 2 * p) // max(c * (p // 2), 1)))


def wide_plan(nchunks: int, resident: int) -> Tuple[int, int]:
    """Kernel B1 wide's grid for nchunks column chunks (of SUBST_COLS) on
    a card that holds `resident` of its blocks at once: (blocks, per).
    Every block is resident, and block b owns the chunks b, b + blocks,
    b + 2 blocks, ...: per or per - 1 of them, so no block walks the waves
    for more chunks than another but one."""
    if nchunks < 1 or resident < 1:
        raise ValueError(f"no B1 wide grid for {nchunks} chunks on "
                         f"{resident} resident blocks")
    per = -(-nchunks // resident)
    return -(-nchunks // per), per


@functools.lru_cache(maxsize=None)
def wide_resident(index: int) -> Tuple[int, int]:
    """(blocks per SM, SMs) of kernel B1 wide on CUDA device `index`."""
    with torch.cuda.device(index):
        bps = _cuda.lib().spasm_subst_blocks_per_sm(1)
    if bps < 1:        # negative: the CUDA error of the occupancy query
        raise RuntimeError(f"kernel B1 wide: {bps} blocks per SM")
    return bps, torch.cuda.get_device_properties(index).multi_processor_count


def subst_waves(R: torch.Tensor, rows: np.ndarray, ref_ptr: np.ndarray,
                refs: np.ndarray, coef: np.ndarray, bounds: np.ndarray,
                p: int) -> None:
    """Run the substitution on R (npad, M) IN PLACE, R of
    `storage_dtype(p)`.

    rows (n,) R row ids in processing order; ref_ptr (n + 1,) offsets
    into refs (R row ids) / coef (balanced ints); bounds (ngroups + 1,)
    wave boundaries into rows.  A CUDA tensor launches kernel B1 (int16
    R) or B1 wide (int32 R), a CPU tensor takes the plain version."""
    dtype = storage_dtype(p)
    if R.dtype != dtype or R.dim() != 2 or not R.is_contiguous():
        raise ValueError(f"R must be a contiguous 2-D {dtype} tensor for "
                         f"p = {p}")
    npad, M = R.shape
    bounds = np.ascontiguousarray(bounds, np.int64)
    n = len(rows)
    if len(ref_ptr) != n + 1 or bounds[0] != 0 or bounds[-1] != n:
        raise ValueError("inconsistent wave arrays")
    if n == 0:
        return
    if int(np.max(rows)) >= npad or (len(refs) and int(np.max(refs)) >= npad):
        raise ValueError("row id out of range")
    if R.device.type == "cpu":
        _subst_waves_plain(R, rows, ref_ptr, refs, coef, bounds, p)
        return
    if R.device.type != "cuda":
        raise ValueError(f"unsupported device {R.device}")
    if M == 0:
        return
    if M % SUBST_COLS or R.data_ptr() % 16:
        raise ValueError(f"kernel B1 needs M % {SUBST_COLS} == 0 and "
                         "16-byte rows")
    ngroups = len(bounds) - 1
    nrefs = int(ref_ptr[-1])
    if n + nrefs >= 1 << 30:
        raise ValueError("kernel B1 takes fewer than 2^30 rows + references")
    coef = np.asarray(coef)[:nrefs]
    # the schedule as one int32 array: one copy to the card
    sched = np.concatenate([
        bounds, rows, ref_ptr, np.asarray(refs)[:nrefs],
        coef]).astype(np.int32)
    if dtype == torch.int32:     # before the copy, which waits for the card
        cmax = max(int(coef.max(initial=0)), -int(coef.min(initial=0)))
        nred = nred_wide(p, cmax)
    sched_d = torch.from_numpy(sched).to(R.device)
    L = _cuda.lib()
    if L.spasm_subst_cols() != SUBST_COLS:
        raise RuntimeError("csrc/subst.cu kCols disagrees with SUBST_COLS")
    # <<<>>> launches on the current device: make it R's
    with torch.cuda.device(R.device):
        if dtype == torch.int16:
            err = L.spasm_subst_waves(R.data_ptr(), M, sched_d.data_ptr(), n,
                                      nrefs, ngroups, nred_for(p), p,
                                      _cuda.stream_ptr(R))
            name = "B1"
        else:
            bps, sms = wide_resident(torch.cuda.current_device())
            grid, _ = wide_plan(M // SUBST_COLS, bps * sms)
            err = L.spasm_subst_waves_wide(
                R.data_ptr(), M, sched_d.data_ptr(), n, nrefs, ngroups,
                nred, p, grid, _cuda.stream_ptr(R))
            name = "B1 wide"
    _cuda.check(err, f"kernel {name} (spasm_subst_waves)")
    _cuda.launches[name] += 1
    _cuda.calls[name] += 1


def _subst_waves_plain(R, rows, ref_ptr, refs, coef, bounds, p: int):
    """The same wave loop in torch: gather, int64 weighted sum, mod.  On
    int32 storage each product (< 2^62) is reduced before the sum."""
    dev = R.device
    M = R.shape[1]
    rows = np.asarray(rows, np.int64)
    ref_ptr = np.asarray(ref_ptr, np.int64)
    refs_t = torch.as_tensor(np.asarray(refs, np.int64), device=dev)
    coef_t = torch.as_tensor(np.asarray(coef, np.int64), device=dev)
    for g in range(len(bounds) - 1):
        r0 = int(bounds[g])
        r1g = int(bounds[g + 1])
        while r0 < r1g:
            # rows of a wave are independent: chunk them to the budget
            lim = ref_ptr[r0] + _PLAIN_BUDGET // M
            r1 = int(np.searchsorted(ref_ptr, lim, side="right")) - 1
            r1 = min(max(r1, r0 + 1), r1g)
            s0, s1 = int(ref_ptr[r0]), int(ref_ptr[r1])
            rr = torch.as_tensor(rows[r0:r1], device=dev)
            seg = torch.as_tensor(
                np.repeat(np.arange(r1 - r0), np.diff(ref_ptr[r0:r1 + 1])),
                device=dev)
            acc = R[rr].to(torch.int64)
            contrib = coef_t[s0:s1, None] * R[refs_t[s0:s1]].to(torch.int64)
            if R.dtype == torch.int32:
                contrib = dnorm64(contrib, p)
            acc.index_add_(0, seg, contrib, alpha=-1)
            R[rr] = dnorm64(acc, p).to(R.dtype)
            r0 = r1
