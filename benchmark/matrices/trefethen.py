"""Trefethen_n: A(i, i) = the i-th prime, A(i, j) = 1 where |i - j| is a
power of 2 (SuiteSparse JGD_Trefethen).  n = 20000 gives Trefethen_20000
(554466 nonzeros), n = 2000 the repository's tests/Matrix/trefethen_2000.

`generate(n)` returns (n, n, indptr int64, indices int32, values int64)
with the values as published (not reduced mod any prime), each row's
columns ascending.
"""
from __future__ import annotations

import numpy as np


def primes(count: int) -> np.ndarray:
    """The first `count` primes (int64), by a sieve of Eratosthenes."""
    limit = max(16, int(count * (np.log(count + 2) + np.log(np.log(count + 2)))) + 16)
    while True:
        sieve = np.ones(limit + 1, bool)
        sieve[:2] = False
        for q in range(2, int(limit ** 0.5) + 1):
            if sieve[q]:
                sieve[q * q::q] = False
        found = np.flatnonzero(sieve)
        if found.size >= count:
            return found[:count].astype(np.int64)
        limit *= 2


def generate(n: int):
    offsets = [0]
    d = 1
    while d < n:
        offsets += [d, -d]
        d *= 2
    rows, cols, vals = [], [], []
    diag = primes(n)
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off), dtype=np.int64)
        rows.append(i)
        cols.append(i + off)
        vals.append(diag[i] if off == 0 else np.ones(i.size, np.int64))
    r, c, v = (np.concatenate(x) for x in (rows, cols, vals))
    order = np.lexsort((c, r))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])
    return n, n, indptr, c[order].astype(np.int32), v[order]
