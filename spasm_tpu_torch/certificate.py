"""Certificates of a factorization.

Port of `factorization_verify` from spasm_tpu/certificate.py (the
reference's spasm_certificate.c:164-219).  Rank certificates
(create / verify / save / load) wait for the other CLI tools (ROADMAP:
L-mode's remaining consumers and the other CLI tools).
"""
from __future__ import annotations

import numpy as np

from .csr import CSR
from .echelonize import LU
from .hashing import PRNG
from .spmv import xApy


def factorization_verify(A: CSR, fact: LU, seed: int) -> bool:
    """Probabilistic check x.A == (x.L).U on a random x drawn from the
    SHA-256 PRNG (on the pivotal rows only unless fact.complete)."""
    assert fact.L is not None
    L, U = fact.L, fact.U
    n, m = A.n, A.m
    r = U.n
    pivotal = np.zeros(n, dtype=bool)
    pivotal[np.asarray(fact.p[:r], np.int64)] = True
    gen = PRNG.from_u64(A.prime, seed, 0)
    # the reference draws for EVERY row and zeroes non-pivotal ones, so
    # the batched draw consumes the same stream
    x = gen.zzp_array(n).astype(np.int32)
    if not fact.complete:
        x[~pivotal] = 0
    t = np.zeros(m, dtype=np.int32)
    xApy(x, A, t)
    y = np.zeros(r, dtype=np.int32)
    xApy(x, L, y)
    z = np.zeros(m, dtype=np.int32)
    xApy(y, U, z)
    return bool(np.array_equal(z, t))
