"""Inputs and timers shared by the card tests (tests/test_torch_cuda.py)
and chip_smoke.py, kept beside them and out of the spasm_tpu_torch
package: random substitution waves for kernel B1, sub-panels for the row
sweeps B2/B3, column panels for the panel kernel B4, blocks for the
gather-combine B12, bench.py config 5's two instances (`scc_banded`,
`upper_triangular`, copied here because bench.py imports the JAX
package), and CUDA-event timing.

Inputs are made with numpy from an explicit Generator, so a kernel and its
plain version see the same numbers on any device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def balanced(rng: np.random.Generator, shape, p: int) -> np.ndarray:
    """Uniform balanced residues in [-(p//2), p//2], int64."""
    return rng.integers(-(p // 2), p // 2 + 1, shape)


def random_waves(rng: np.random.Generator, n: int, nwaves: int,
                 max_refs: int, p: int):
    """Arrays for `dense.subst.subst_waves` over R rows 0..n-1 processed
    in id order: nwaves waves of random sizes; each row outside the first
    wave references up to max_refs rows of earlier waves (repeats
    allowed).  Returns (rows, ref_ptr, refs, coef, bounds)."""
    cuts = np.sort(rng.choice(np.arange(1, n), nwaves - 1, replace=False))
    bounds = np.concatenate(([0], cuts, [n])).astype(np.int64)
    wave_start = np.repeat(bounds[:-1], np.diff(bounds))
    k = np.minimum(rng.integers(0, max_refs + 1, n), wave_start)
    ref_ptr = np.concatenate(([0], np.cumsum(k))).astype(np.int64)
    lim = np.repeat(wave_start, k)
    refs = np.floor(rng.random(lim.size) * lim).astype(np.int64)
    coef = balanced(rng, refs.size, p).astype(np.int32)
    return np.arange(n, dtype=np.int64), ref_ptr, refs, coef, bounds


def combine_inputs(rng: np.random.Generator, S: int, K: int, w: int,
                   p: int, live: float = 0.06, npad: int = 256):
    """Inputs of kernel B12 (`dense.reduced.gather_combine`) and its
    plain version: X (S, w) and V (S, K) balanced int32, R (npad, w)
    balanced int64 whose last row is zero (the dead row), refs (S, K)
    int64 R row ids.  About `live` of the slots reference a row of R
    with V != 0; of the others half point at the dead row and half carry
    V = 0.  R's rows 0 and 1 are +-(p - 1)/2 throughout; row 1 of the
    block has only dead slots, rows 2 and 3 (where S > 3) take V =
    (p - 1)/2 on every slot against R's row 0, and alternating
    +-(p - 1)/2 against row 1: the largest sums."""
    half = (p - 1) // 2
    R = balanced(rng, (npad, w), p)
    R[0], R[1], R[-1] = half, -half, 0
    X = balanced(rng, (S, w), p).astype(np.int32)
    refs = rng.integers(0, npad - 1, (S, K))
    V = balanced(rng, (S, K), p)
    dead = rng.random((S, K)) >= live
    at_dead = dead & (rng.random((S, K)) < 0.5)
    refs[at_dead] = npad - 1
    V[dead & ~at_dead] = 0
    if S > 1:
        refs[1] = npad - 1
    if S > 3:
        V[2], refs[2] = half, 0
        V[3], refs[3] = np.where(np.arange(K) % 2, half, -half), 1
    return X, V.astype(np.int32), R, refs


def deficient_panel(rng: np.random.Generator, nb: int, M: int, r: int,
                    p: int, empty_cols: int = 0) -> np.ndarray:
    """(nb, M) balanced int32 block of rank <= r with the last column dead,
    every 7th row zero and the first empty_cols columns zero (so a tiled
    sweep meets tiles without a candidate row)."""
    W = balanced(rng, (nb, r), p)
    W[rng.random((nb, r)) < 0.5] = 0
    G = np.where(rng.random((r, M)) < 0.3, balanced(rng, (r, M), p), 0)
    X = (W @ G) % p
    X = np.where(X > p // 2, X - p, X)
    X[:, -1] = 0
    X[:, :empty_cols] = 0
    X[::7] = 0
    return X.astype(np.int32)


def b3_panel(rng: np.random.Generator, case: str, M: int,
             p: int) -> np.ndarray:
    """(64, M) int32 input of the tiled sweep B3, by case:
      full                  dense balanced, full rank in the first tile;
      rank40                `deficient_panel` of rank <= 40;
      staircase             row t (t < M / 512) nonzero from tile t on,
                            the other rows zero: one pivot per tile;
      zero                  all zero;
      empty_lead            rank <= 40 with the first 2 tiles and 100
                            columns zero;
      row_first_tile_empty  rank <= 40, row 3 zero on the first tile but
                            for one entry in the second."""
    tw = 512
    if case == "full":
        return balanced(rng, (64, M), p).astype(np.int32)
    if case == "rank40":
        return deficient_panel(rng, 64, M, 40, p)
    if case == "staircase":
        X = np.zeros((64, M), np.int64)
        for t in range(min(M // tw, 64)):
            X[t, t * tw + 7:] = balanced(rng, M - t * tw - 7, p)
        return X.astype(np.int32)
    if case == "zero":
        return np.zeros((64, M), np.int32)
    if case == "empty_lead":
        return deficient_panel(rng, 64, M, 40, p, empty_cols=2 * tw + 100)
    if case == "row_first_tile_empty":
        X = deficient_panel(rng, 64, M, 40, p)
        X[3, :tw] = 0
        X[3, tw + 5] = 9 % p - p * (9 % p > p // 2)
        return X
    raise ValueError(case)


def b2_panel(rng: np.random.Generator, case: str, nb: int, M: int,
             p: int) -> np.ndarray:
    """(nb, M) int32 input of the leftmost-rule sweep B2: the first nb rows
    of a 64-row panel, by case:
      rank40    `deficient_panel` of rank <= 40, first 700 columns zero;
      zero      all zero;
      full      dense balanced (full rank);
      boundary  row i nonzero from column (i % 8) M / 8 on, one column
                earlier for every third row: pivots on and beside the
                cluster variant's slice boundaries (M / 8 columns each)."""
    if case == "rank40":
        X = deficient_panel(rng, 64, M, 40, p, empty_cols=700)
    elif case == "zero":
        X = np.zeros((64, M), np.int32)
    elif case == "full":
        X = balanced(rng, (64, M), p).astype(np.int32)
    elif case == "boundary":
        X = balanced(rng, (64, M), p)
        for i in range(64):
            X[i, :max(0, (i % 8) * (M // 8) - (i % 3 == 0))] = 0
        X = X.astype(np.int32)
    else:
        raise ValueError(case)
    return np.ascontiguousarray(X[:nb])


def panel_block(rng: np.random.Generator, n: int, p: int):
    """(n, 192) balanced int32 block whose columns 64..127 are the panel
    of kernel B4 (read through the block's row stride): 60 % zeros, every
    9th row zero, panel column 7 a copy of column 2 and column 40 empty;
    and an (n,) bool mask with ~10 % of the rows already pivotal."""
    X = balanced(rng, (n, 192), p)
    X[rng.random((n, 192)) < 0.6] = 0
    X[:, 64 + 7] = X[:, 64 + 2]
    X[:, 64 + 40] = 0
    X[::9] = 0
    return X.astype(np.int32), rng.random(n) < 0.1


def scc_banded(n: int, blk: int, extra: int, p: int):
    """bench.py config 5's DM instance (bench.py `_scc_banded`): n x n
    with ~n/blk SCCs of size blk: unit diagonal, a superdiagonal within
    each block, a band-closing entry per block, and `extra` random
    strictly-upper entries (cross-SCC DAG edges)."""
    from spasm_tpu_torch.csr import COO
    rng = np.random.default_rng(7)
    di = np.arange(n)
    sup_i = np.asarray([i for i in range(n) if (i + 1) % blk], np.int64)
    sup_j = sup_i + 1
    base = np.arange(0, n - blk + 1, blk)
    close_i, close_j = base, base + blk - 1          # cycle closers
    xi = rng.integers(0, n - 1, extra)
    xj = rng.integers(1, n, extra)
    up = xi < xj
    # within-block chain points UP (i -> i+1); the closer points DOWN
    # (base+blk-1 -> base), so each block is one directed cycle = 1 SCC
    rows = np.concatenate([di, sup_i, close_j, xi[up]])
    cols = np.concatenate([di, sup_j, close_i, xj[up]])
    vals = rng.integers(1, p, rows.size)
    T = COO.from_entries(n, n, p, rows, cols, vals)
    return T.tocsr()


def upper_triangular(n: int, p: int):
    """bench.py config 5's certificate instance (bench.py
    `bench_dm_cert`): n x n of full rank, a nonzero diagonal plus 4n
    random strictly-upper entries, so every pivot is structural."""
    from spasm_tpu_torch.csr import COO
    rng = np.random.default_rng(11)
    di = np.arange(n)
    xi = rng.integers(0, n - 1, 4 * n)
    xj = rng.integers(1, n, 4 * n)
    keep = xi < xj
    T = COO.from_entries(n, n, p, np.concatenate([di, xi[keep]]),
                         np.concatenate([di, xj[keep]]),
                         rng.integers(1, p, n + int(keep.sum())))
    T.n = T.m = n
    return T.tocsr()


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream, by CUDA
    events around reps calls after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps
