"""Trefethen_nb: Trefethen_n (matrices/trefethen.py) without its first row
and column, the (1, 1) minor (SuiteSparse JGD_Trefethen/Trefethen_20000b
at n = 20000: 19999 x 19999, 554435 nonzeros; Trefethen_20b at n = 20,
147).  A(i, i) = the (i + 1)-th prime, A(i, j) = 1 where |i - j| is a
power of 2.

`generate(n)` returns (n - 1, n - 1, indptr int64, indices int32, values
int64) in the form `trefethen.generate` returns, values as published.
"""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np


def _trefethen():
    """matrices/trefethen.py, loaded by path from beside this file."""
    path = pathlib.Path(__file__).with_name("trefethen.py")
    spec = importlib.util.spec_from_file_location("trefethen_of_minor", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generate(n: int):
    _, _, indptr, indices, values = _trefethen().generate(n)
    start = int(indptr[1])                       # row 0 left out
    rows = np.repeat(np.arange(n - 1), np.diff(indptr[1:]))
    keep = indices[start:] > 0                   # column 0 left out
    out = np.zeros(n, np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=n - 1), out=out[1:])
    return (n - 1, n - 1, out, (indices[start:][keep] - 1).astype(np.int32),
            values[start:][keep])
