"""Native (C++) host kernels of the structural pivot search and the
batched sparse triangular solves, via ctypes.

The source is the port's own `spasm_kernels.cpp` beside this file (a
copy of the JAX package's `spasm_tpu/native/spasm_kernels.cpp`; it
includes nothing of JAX or Python), compiled with g++ into
`build/spasm_tpu_torch/native/` under the repository root.  The build
happens on first use, never at import; when no toolchain is available
`available()` is False and the call sites run their pure-Python paths.

Surface (the subset the ported paths call):
  solve_batch        — parallel batched sparse triangular solves
  gplu               — sequential Gilbert-Peierls LU with leftmost pivots
  cycle_free_pivots  — greedy alternating-cycle-free pivot search
  fl_column_pivots   — Faugere-Lachartre pass on columns
  topo_order         — topological order of the pivotal rows
  row_levels         — topological levels of the pivotal rows
  matching           — maximum bipartite matching (DFS with lookahead)
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys
from typing import List, Tuple

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC = pathlib.Path(__file__).resolve().parent / "spasm_kernels.cpp"
_LIB_DIR = _ROOT / "build" / "spasm_tpu_torch" / "native"

_lib = None
_tried = False


def _build():
    _LIB_DIR.mkdir(parents=True, exist_ok=True)
    so = _LIB_DIR / "libspasm_kernels.so"
    if so.exists() and so.stat().st_mtime >= _SRC.stat().st_mtime:
        return so
    tmp = f"{so}.{os.getpid()}.tmp"        # concurrent builds never clash
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           "-std=c++17", str(_SRC), "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"[spasm_tpu_torch.native] build error: {e}\n")
        return None
    if r.returncode != 0:
        sys.stderr.write("[spasm_tpu_torch.native] build failed:\n"
                         + r.stderr.decode()[:2000] + "\n")
        return None
    os.replace(tmp, so)
    return so


def available() -> bool:
    """Build and load the library on first call; True when loaded."""
    global _lib, _tried
    if _tried:
        return _lib is not None
    _tried = True
    if not _SRC.exists():
        return False
    so = _build()
    if so is None:
        return False
    lib = ctypes.CDLL(str(so))
    I64 = ctypes.POINTER(ctypes.c_int64)
    I32 = ctypes.POINTER(ctypes.c_int32)
    lib.spasm_solve_batch.restype = ctypes.c_int64
    lib.spasm_solve_batch.argtypes = [
        I64, I32, I32, ctypes.c_int32, ctypes.c_int32,
        I64, I32, I32, ctypes.c_int32,
        I64, ctypes.c_int64, I64, ctypes.c_int64, ctypes.c_int32, I64]
    lib.spasm_solve_fetch.argtypes = [I64, I32, I32]
    # widths follow the C signatures in spasm_kernels.cpp (i64 = int64_t,
    # i32 = int32_t): a mismatch corrupts results without an error
    lib.spasm_gplu.restype = ctypes.c_int64
    lib.spasm_gplu.argtypes = [
        I64, I32, I32, ctypes.c_int32, ctypes.c_int32,
        I64, ctypes.c_int64, I64,
        I64, I32, I32, ctypes.c_int32,
        I64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64]
    lib.spasm_gplu_sizes.argtypes = [I64]
    lib.spasm_gplu_fetch.argtypes = [I64, I32, I32, I64, I64, I32, I64]
    lib.spasm_matching.restype = ctypes.c_int64
    lib.spasm_matching.argtypes = [I64, I32, ctypes.c_int32,
                                   ctypes.c_int32, I64, I64]
    lib.spasm_cycle_free_pivots.restype = ctypes.c_int64
    lib.spasm_cycle_free_pivots.argtypes = [
        I64, I32, ctypes.c_int32, ctypes.c_int32, I64, I64,
        ctypes.c_int64]
    lib.spasm_fl_column_pivots.restype = ctypes.c_int64
    lib.spasm_fl_column_pivots.argtypes = [
        I64, I32, ctypes.c_int32, ctypes.c_int32, I64, I64]
    lib.spasm_topo_order.restype = ctypes.c_int64
    lib.spasm_topo_order.argtypes = [
        I64, I32, ctypes.c_int32, ctypes.c_int32, I64, I64, I64]
    lib.spasm_row_levels.argtypes = [
        I64, I32, ctypes.c_int32, ctypes.c_int32, I64, ctypes.c_int64,
        I64, I64]
    _lib = lib
    return True


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


_EMPTY64 = np.zeros(1, np.int64)
_EMPTY32 = np.zeros(1, np.int32)


def _arr64(a) -> np.ndarray:
    a = np.ascontiguousarray(a, np.int64)
    return a if a.size else _EMPTY64


def _arr32(a) -> np.ndarray:
    a = np.ascontiguousarray(a, np.int32)
    return a if a.size else _EMPTY32


def cycle_free_pivots(A, pinv: np.ndarray, qinv: np.ndarray,
                      work_budget: int = 0) -> int:
    return int(_lib.spasm_cycle_free_pivots(
        _p64(_arr64(A.indptr)), _p32(_arr32(A.indices)), A.n, A.m,
        _p64(pinv), _p64(qinv), work_budget))


def fl_column_pivots(A, pinv: np.ndarray, qinv: np.ndarray) -> int:
    return int(_lib.spasm_fl_column_pivots(
        _p64(_arr64(A.indptr)), _p32(_arr32(A.indices)), A.n, A.m,
        _p64(pinv), _p64(qinv)))


def topo_order(A, pinv: np.ndarray, qinv: np.ndarray) -> np.ndarray:
    p = np.empty(A.n, np.int64)
    _lib.spasm_topo_order(
        _p64(_arr64(A.indptr)), _p32(_arr32(A.indices)), A.n, A.m,
        _p64(_arr64(pinv)), _p64(_arr64(qinv)),
        _p64(p if A.n else _EMPTY64))
    return p


def row_levels(A, rows: np.ndarray, pinv: np.ndarray) -> np.ndarray:
    npiv = int(np.asarray(rows).size)
    rows = _arr64(rows)
    out = np.zeros(max(npiv, 1), np.int64)
    _lib.spasm_row_levels(
        _p64(_arr64(A.indptr)), _p32(_arr32(A.indices)), A.n, A.m,
        _p64(rows), npiv, _p64(_arr64(pinv)), _p64(out))
    return out[:npiv]


def solve_batch(U, B, rows, qinv, prime: int, nthreads: int = 0,
                mask_cols=None) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Batched x*U = B[row] solves.  Returns [(cols, vals)] per row with
    coefficients on pivotal columns and the Schur residue elsewhere,
    column-sorted.  mask_cols (optional, per row): one column treated as
    non-pivotal during that row's solve (-1 = none)."""
    rows = _arr64(rows)
    mc = _arr64(mask_cols) if mask_cols is not None else None
    total = _lib.spasm_solve_batch(
        _p64(_arr64(U.indptr)), _p32(_arr32(U.indices)),
        _p32(_arr32(U.data)), U.n, U.m,
        _p64(_arr64(B.indptr)), _p32(_arr32(B.indices)),
        _p32(_arr32(B.data)), B.n,
        _p64(rows), len(rows), _p64(_arr64(qinv)), prime, nthreads,
        _p64(mc) if mc is not None else None)
    lens = np.empty(max(len(rows), 1), np.int64)
    cols = np.empty(max(total, 1), np.int32)
    vals = np.empty(max(total, 1), np.int32)
    _lib.spasm_solve_fetch(_p64(lens), _p32(cols), _p32(vals))
    out = []
    off = 0
    for k in range(len(rows)):
        ln = int(lens[k])
        out.append((cols[off:off + ln].copy(), vals[off:off + ln].copy()))
        off += ln
    return out


def gplu(S, rows, row_origin, U0, qinv: np.ndarray, prime: int,
         want_L: bool, max_pivots: int):
    """Sequential GPLU of rows of S against the basis U0: each row is
    solved against U0 and the rows found before it, and its leftmost
    non-pivotal nonzero becomes a new pivot.  qinv (int64, contiguous) is
    updated in place.  Returns (npiv, u_rows [(cols, vals)], l_triplets
    (i, j, x), piv_origin)."""
    if qinv.dtype != np.int64 or not qinv.flags.c_contiguous:
        raise TypeError("gplu updates qinv in place: int64, contiguous")
    rows = _arr64(rows)
    ro = _arr64(row_origin) if row_origin is not None else None
    npiv = _lib.spasm_gplu(
        _p64(_arr64(S.indptr)), _p32(_arr32(S.indices)),
        _p32(_arr32(S.data)), S.n, S.m,
        _p64(rows), len(rows), _p64(ro) if ro is not None else None,
        _p64(_arr64(U0.indptr)), _p32(_arr32(U0.indices)),
        _p32(_arr32(U0.data)), U0.n,
        _p64(qinv), prime, 1 if want_L else 0, max_pivots)
    sizes = np.empty(3, np.int64)
    _lib.spasm_gplu_sizes(_p64(sizes))
    nu, unnz, lnnz = (int(s) for s in sizes)
    u_lens = np.empty(max(nu, 1), np.int64)
    u_cols = np.empty(max(unnz, 1), np.int32)
    u_vals = np.empty(max(unnz, 1), np.int32)
    l_i = np.empty(max(lnnz, 1), np.int64)
    l_j = np.empty(max(lnnz, 1), np.int64)
    l_x = np.empty(max(lnnz, 1), np.int32)
    piv_origin = np.empty(max(nu, 1), np.int64)
    _lib.spasm_gplu_fetch(_p64(u_lens), _p32(u_cols), _p32(u_vals),
                          _p64(l_i), _p64(l_j), _p32(l_x),
                          _p64(piv_origin))
    offs = np.concatenate(([0], np.cumsum(u_lens[:nu])))
    urows = [(u_cols[offs[k]:offs[k + 1]].copy(),
              u_vals[offs[k]:offs[k + 1]].copy()) for k in range(nu)]
    return (int(npiv), urows, (l_i[:lnnz], l_j[:lnnz], l_x[:lnnz]),
            piv_origin[:nu])


def matching(A) -> Tuple[int, np.ndarray, np.ndarray]:
    """Maximum matching of A's bipartite graph: (size, jmatch, imatch),
    jmatch[i] the column matched to row i, imatch[j] the row matched to
    column j (-1 when unmatched)."""
    if not available():
        raise RuntimeError("the native library did not build")
    jmatch = np.empty(A.n, np.int64)
    imatch = np.empty(A.m, np.int64)
    size = _lib.spasm_matching(
        _p64(_arr64(A.indptr)), _p32(_arr32(A.indices)), A.n, A.m,
        _p64(jmatch if A.n else _EMPTY64),
        _p64(imatch if A.m else _EMPTY64))
    return int(size), jmatch, imatch
