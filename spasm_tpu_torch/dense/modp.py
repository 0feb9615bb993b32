"""Exact GF(p) arithmetic on torch tensors (balanced representation).

Port of spasm_tpu/dense/modp.py.  The workhorse is `matmul_digits`: an
exact modular matrix product built from int8 x int8 -> int32 products
(`torch._int_mm`: the int8 tensor cores on the GPU).  Balanced values
are split into base-256 digits in [-128, 127]; the digit products are
summed per anti-diagonal in int32 and recombined with the residues of
256^s mod p.

Scope: the d == 2 digit tier (p <= 65279, which holds the tools' default
modulus 42013), where every step stays in int32.  The d == 3 / 4 tiers
raise NotImplementedError (ROADMAP: the d = 3/4 prime tiers).

The prime is a Python int throughout; reductions use `torch.remainder`,
which gives the unique balanced residue like the JAX package's
float-reciprocal Barrett (the residue is unique, so results are
bit-equal).
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np
import torch

_DIGIT_BITS = 8
_DIGIT_BASE = 1 << _DIGIT_BITS          # 256

# p <= this keeps every product of two balanced values, doubled, in int32
SMALL_MAX_PRIME = 65279


def _k_chunk(d: int) -> int:
    """Max contraction depth per int8 product so each anti-diagonal sum
    stays exact in int32: (#terms <= min(d, s+1)) * k * 16256 < 2^31."""
    if d == 2:
        return 1 << 16
    return 1 << 14 if d >= 4 else 1 << 15


# element budget of one digit-decomposed B chunk: bounds the int32
# temporaries of `_digits` (a whole (65536, 22528) chunk would need GBs)
_MM_BUDGET = 1 << 28


class DeviceField(NamedTuple):
    """Per-prime constants."""
    p: int
    ndigits: int
    weights: np.ndarray      # (2*D - 1,) int64 balanced residues of 256^s


def _digit_reach(d: int) -> int:
    return 127 * (_DIGIT_BASE ** d - 1) // (_DIGIT_BASE - 1)


@functools.lru_cache(maxsize=64)
def device_field(p: int) -> DeviceField:
    d = 2
    while d < 4 and _digit_reach(d) < p // 2:
        d += 1
    halfp = p // 2
    w = np.empty(2 * d - 1, dtype=np.int64)
    for s in range(2 * d - 1):
        r = pow(_DIGIT_BASE, s, p)
        w[s] = r - p if r > halfp else r
    return DeviceField(p, d, w)


def check_prime(p: int) -> None:
    """Raise NotImplementedError outside the ported d == 2 tier."""
    if device_field(p).ndigits != 2:
        raise NotImplementedError(
            f"p = {p} > {SMALL_MAX_PRIME}: the d = 3/4 digit tiers are not "
            "ported yet (ROADMAP: the d = 3/4 prime tiers)")


def dnorm64(x: torch.Tensor, p: int) -> torch.Tensor:
    """Balanced representative of x mod p, int64 out."""
    r = torch.remainder(x.to(torch.int64), p)
    return torch.where(r > p // 2, r - p, r)


def mulmod(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """Balanced product of balanced operands (int64; exact for p < 2^32)."""
    return dnorm64(a.to(torch.int64) * b.to(torch.int64), p)


def modinv(a: torch.Tensor, p: int) -> torch.Tensor:
    """Balanced modular inverse via Fermat (a^(p-2) mod p); 0 maps to 0."""
    a64 = dnorm64(a, p)
    result = torch.ones_like(a64)
    base = a64
    e = p - 2
    while e:
        if e & 1:
            result = mulmod(result, base, p)
        base = mulmod(base, base, p)
        e >>= 1
    return torch.where(a64 == 0, torch.zeros_like(result), result)


def _reduce31(x: torch.Tensor, p: int) -> torch.Tensor:
    """Balanced x mod p for int32 x (any value); int32 out."""
    r = torch.remainder(x.to(torch.int32), p)
    return torch.where(r > (p - 1) >> 1, r - p, r)


def _digits(x: torch.Tensor, d: int) -> List[torch.Tensor]:
    """Balanced int32 -> d int8 digit tensors, base 256, each in
    [-128, 127], with x = sum_s digits[s] * 256^s (d == 2: |x| <= 32639).
    """
    v = x.to(torch.int32)
    out = []
    for _ in range(d):
        lo = ((v + 128) & (_DIGIT_BASE - 1)) - 128
        out.append(lo.to(torch.int8))
        v = (v - lo) >> _DIGIT_BITS
    return out


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _mm8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (n, k) @ int8 (k, m) -> int32 (n, m) through torch._int_mm.

    On CUDA, _int_mm takes more than 16 rows and k, m multiples of 8, and
    cuBLASLt on the H100 (CUDA 12.8) refuses a row count that is not a
    multiple of 32 once m >= 32 (CUBLAS_STATUS_NOT_SUPPORTED); the
    operands are zero-padded to rows a multiple of 32 and k, m multiples
    of 8 (an inert pad) on every device, so the CPU runs the same shapes."""
    n, k = a.shape
    m = b.shape[1]
    n2, k2, m2 = max(-(-n // 32) * 32, 32), _round8(k), _round8(m)
    if (n2, k2) != (n, k):
        a2 = a.new_zeros((n2, k2))
        a2[:n, :k] = a
        a = a2
    if (k2, m2) != (k, m):
        b2 = b.new_zeros((k2, m2))
        b2[:k, :m] = b
        b = b2
    out = torch._int_mm(a.contiguous(), b.contiguous())
    if (n2, m2) != (n, m):
        out = out[:n, :m]
    return out


def _k_step(k: int, m: int, d: int) -> int:
    """Contraction chunk: the exactness limit, shrunk to the memory
    budget of one digit-decomposed (chunk, m) slice of B."""
    kc = min(_k_chunk(d), max(_MM_BUDGET // max(m, 1), 64))
    return max(kc - kc % 8, 8)


def matmul_digits_i8B(A: torch.Tensor, B8: torch.Tensor, p: int
                      ) -> torch.Tensor:
    """Exact (A @ B8) mod p where B8 is int8 (|values| <= 127, a single
    base-256 digit): only A is digit-decomposed, d products instead of
    d * d."""
    check_prime(p)
    n, k = A.shape
    m = B8.shape[1]
    w1 = int(device_field(p).weights[1])
    acc = torch.zeros((n, m), dtype=torch.int32, device=A.device)
    kc = _k_step(k, m, 2)
    for lo in range(0, k, kc):
        hi = min(k, lo + kc)
        a0, a1 = _digits(A[:, lo:hi], 2)
        Bc = B8[lo:hi]
        b0 = _reduce31(_mm8(a0, Bc), p)
        b1 = _reduce31(_mm8(a1, Bc), p)
        acc = _reduce31(acc + _reduce31(b0 + w1 * b1, p), p)
    return acc


def matmul_digits(A: torch.Tensor, B: torch.Tensor, p: int) -> torch.Tensor:
    """Exact (A @ B) mod p; A, B balanced integers of any width, out
    balanced int32.  B may be int8 (one digit): then the d-product
    variant runs."""
    if B.dtype == torch.int8:
        return matmul_digits_i8B(A, B, p)
    check_prime(p)
    n, k = A.shape
    m = B.shape[1]
    w = device_field(p).weights
    w1, w2 = int(w[1]), int(w[2])
    acc = torch.zeros((n, m), dtype=torch.int32, device=A.device)
    kc = _k_step(k, m, 2)
    for lo in range(0, k, kc):
        hi = min(k, lo + kc)
        a0, a1 = _digits(A[:, lo:hi], 2)
        b0, b1 = _digits(B[lo:hi], 2)
        # anti-diagonals: |sum| <= 2 * kc * 16256 < 2^31
        d0 = _reduce31(_mm8(a0, b0), p)
        d1 = _mm8(a0, b1)
        d1 += _mm8(a1, b0)
        d1 = _reduce31(d1, p)
        d2 = _reduce31(_mm8(a1, b1), p)
        # p/2 + 2 * (p/2)^2 < 2^31 for p <= 65279: int32 throughout
        d0 += w1 * d1
        d0 += w2 * d2
        acc = _reduce31(acc + _reduce31(d0, p), p)
    return acc
