"""Rank certificates (Eberly 2015, Fiat-Shamir non-interactive) and
probabilistic factorization verification.

Vendored from spasm_tpu/certificate.py, a port of SpaSM
src/spasm_certificate.c.  The challenge streams are bit-compatible with
the reference (seeded from the SHA-256 matrix fingerprint), so
certificates interoperate across implementations: one written by the JAX
package verifies here, and the reverse.

Note: the reference's spasm_rank_certificate_load fills proof->i twice
and never proof->j (spasm_certificate.c:262-265) — a bug SURVEY.md flags
as not-to-be-reproduced; `load` here is correct.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .csr import CSR
from .echelonize import LU
from .hashing import PRNG
from .solve import solve
from .spmv import xApy

_BOT = 0x7FFFFFFF


@dataclasses.dataclass
class RankCertificate:
    r: int
    prime: int
    hash: bytes            # 32-byte matrix fingerprint
    i: np.ndarray          # (r,) pivot row positions
    j: np.ndarray          # (r,) pivot column positions
    x: np.ndarray          # (r,) challenge response
    y: np.ndarray          # (r,) challenge response


def rank_certificate_create(A: CSR, hash_: bytes, fact: LU
                            ) -> RankCertificate:
    """(spasm_certificate_rank_create, spasm_certificate.c:21-95)"""
    assert fact.L is not None
    U = fact.U
    n = fact.L.n
    m = U.m
    r = U.n
    ii = np.asarray(fact.p[:r], dtype=np.int64)
    jj = np.nonzero(np.asarray(fact.qinv) >= 0)[0].astype(np.int64)

    gen = PRNG(A.prime, hash_, 0)
    # challenge 1: y supported on pivot columns (batched draws consume
    # the stream exactly like the reference's per-element loop)
    y = np.zeros(m, dtype=np.int64)
    y[jj] = gen.zzp_array(r)
    _, x = solve(fact, y)
    xx = x[ii].astype(np.int32)

    # challenge 2: x random outside pivot rows (ascending row order)
    xv = np.full(n, _BOT, dtype=np.int64)
    xv[ii] = 0
    free = np.nonzero(xv == _BOT)[0]
    xv[free] = -gen.zzp_array(free.size).astype(np.int64)
    y = np.zeros(m, dtype=np.int32)
    xApy(xv.astype(np.int32), A, y)
    _, x2 = solve(fact, y.astype(np.int64))
    yy = x2[ii].astype(np.int32)
    return RankCertificate(r, A.prime, bytes(hash_), ii, jj, xx, yy)


def rank_certificate_verify(A: CSR, hash_: bytes,
                            proof: RankCertificate) -> bool:
    """Two SpMVs, no factorization needed
    (spasm_certificate_rank_verify, spasm_certificate.c:97-161)."""
    n, m = A.n, A.m
    r = proof.r
    if bytes(hash_) != bytes(proof.hash):
        return False
    if A.prime != proof.prime:
        return False
    if np.any((proof.i < 0) | (proof.i >= n)):
        return False
    if np.any((proof.j < 0) | (proof.j >= m)):
        return False
    gen = PRNG(proof.prime, proof.hash, 0)
    correct = True
    # check 1: (x placed at pivot rows) * A matches the challenge stream
    x = np.zeros(n, dtype=np.int32)
    x[proof.i] = proof.x
    y = np.zeros(m, dtype=np.int32)
    xApy(x, A, y)
    if not np.array_equal(y[proof.j],
                          gen.zzp_array(r).astype(np.int32)):
        correct = False
    # check 2: (y at pivot rows, challenge elsewhere) * A == 0
    xv = np.full(n, _BOT, dtype=np.int64)
    xv[proof.i] = proof.y
    free = np.nonzero(xv == _BOT)[0]
    xv[free] = gen.zzp_array(free.size).astype(np.int64)
    y = np.zeros(m, dtype=np.int32)
    xApy(xv.astype(np.int32), A, y)
    if np.any(y):
        correct = False
    return correct


def factorization_verify(A: CSR, fact: LU, seed: int) -> bool:
    """Probabilistic check x.A == (x.L).U on a random x
    (spasm_factorization_verify, spasm_certificate.c:164-219)."""
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


def certificate_save(proof: RankCertificate, f):
    """(spasm_rank_certificate_save, spasm_certificate.c:221-241)"""
    close = isinstance(f, (str, bytes)) or hasattr(f, "__fspath__")
    if close:
        f = open(f, "w")
    try:
        f.write(f"{proof.r}\n{proof.prime}\n")
        f.write(bytes(proof.hash).hex() + "\n")
        for arr in (proof.i, proof.j, proof.x, proof.y):
            f.write(" ".join(str(int(v)) for v in arr) + " \n")
    finally:
        if close:
            f.close()


def certificate_load(f) -> Optional[RankCertificate]:
    """Correct version of spasm_rank_certificate_load (the reference never
    fills proof->j, spasm_certificate.c:262-265)."""
    close = isinstance(f, (str, bytes)) or hasattr(f, "__fspath__")
    if close:
        f = open(f, "r")
    try:
        toks = f.read().split("\n")
        r = int(toks[0])
        prime = int(toks[1])
        h = bytes.fromhex(toks[2].strip())
        arrs = []
        for k in range(4):
            arrs.append(np.asarray([int(t) for t in toks[3 + k].split()],
                                   dtype=np.int64))
            if arrs[-1].size != r:
                return None
        return RankCertificate(r, prime, h, arrs[0], arrs[1],
                               arrs[2].astype(np.int32),
                               arrs[3].astype(np.int32))
    except (ValueError, IndexError):
        return None
    finally:
        if close:
            f.close()
