"""Exact GF(p) arithmetic on torch tensors (balanced representation).

Port of spasm_tpu/dense/modp.py.  The workhorse is `matmul_digits`: an
exact modular matrix product built from int8 x int8 -> int32 products
(`torch._int_mm`: the int8 tensor cores on the GPU).  Balanced values
are split into base-256 digits in [-128, 127]; the digit products are
summed per anti-diagonal in int32 and recombined with the residues of
256^s mod p.

Every odd prime p <= 2^32 - 5, in three digit tiers (`device_field(p)
.ndigits`, the one place the tier is chosen): d == 2 (p <= 65279, which
holds the tools' default modulus 42013), where every step stays in
int32; d == 3 (p <= 16711421), where each anti-diagonal reduces in
int32 and is weighted in int64 (products of balanced values < 2^47);
d == 4 (p <= 2^32 - 5), where the diagonals are weighted in int64
directly (one product < 2^62, reduced at once).  Balanced values fit
int32 in every tier; only products and sums widen.

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

from ..profiling import annotate

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


def check_small(p: int, what: str) -> None:
    """Raise NotImplementedError for p above the d == 2 tier: `what` (a
    kernel whose division-free updates need 2 (p/2)^2 < 2^31) has no
    wide-field variant yet (ROADMAP: B8)."""
    if device_field(p).ndigits != 2:
        raise NotImplementedError(
            f"p = {p} > {SMALL_MAX_PRIME}: {what} takes the d = 2 tier "
            "only (ROADMAP: B8, the wide-field variants of B2/B3/B4)")


def storage_dtype(p: int) -> torch.dtype:
    """Storage of balanced rows (R, the finisher's basis): int16 holds
    every balanced value while p <= 65535, int32 above."""
    return torch.int16 if p <= 65535 else torch.int32


def dnorm64(x: torch.Tensor, p: int) -> torch.Tensor:
    """Balanced representative of x mod p, int64 out."""
    r = torch.remainder(x.to(torch.int64), p)
    return torch.where(r > p // 2, r - p, r)


def dnorm(x, p, rounds: int = 2):
    """Balanced representative of x mod p, int32 out.  `rounds` (the JAX
    package's float-reciprocal Barrett passes) is kept for the signature
    only: torch.remainder is exact for every int64, and two Barrett
    rounds are exact in their domain (|x| <= p * 2^30), so the results
    are equal there."""
    return dnorm64(x, p).to(torch.int32)


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


def _digits(x: torch.Tensor, d: int, p: int = 0) -> List[torch.Tensor]:
    """Balanced int32 -> d int8 digit tensors, base 256, each in
    [-128, 127], with x = sum_s digits[s] * 256^s (mod p).  d <= 3 works
    in int32 (|x| <= 8355711); d == 4 in int64, where values above the
    positive digit reach 2139062143 (below (2^32 - 5) // 2) are mapped to
    v - p, which the wider negative reach holds."""
    if d >= 4:
        v = x.to(torch.int64)
        v = torch.where(v > _digit_reach(4), v - p, v)
    else:
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


@annotate("matmul_digits")
def matmul_digits_i8B(A: torch.Tensor, B8: torch.Tensor, p: int
                      ) -> torch.Tensor:
    """Exact (A @ B8) mod p where B8 is int8 (|values| <= 127, a single
    base-256 digit): only A is digit-decomposed, d products instead of
    d * d."""
    F = device_field(p)
    d = F.ndigits
    n, k = A.shape
    m = B8.shape[1]
    kc = _k_step(k, m, d)
    if d > 2:
        # each digit product (<= kc * 16256 < 2^31) reduces in int64 (p
        # may exceed int32) and is weighted there: |b * w| < 2^62
        acc = torch.zeros((n, m), dtype=torch.int64, device=A.device)
        for c, lo in enumerate(range(0, k, kc)):
            Bc = B8[lo:lo + kc]
            for s, a in enumerate(_digits(A[:, lo:lo + kc], d, p)):
                b = dnorm64(_mm8(a, Bc), p)
                acc += dnorm64(b * int(F.weights[s]), p)
            if (c + 1) % 64 == 0:
                acc = dnorm64(acc, p)
        return dnorm64(acc, p).to(torch.int32)
    w1 = int(F.weights[1])
    acc = torch.zeros((n, m), dtype=torch.int32, device=A.device)
    for lo in range(0, k, kc):
        hi = min(k, lo + kc)
        a0, a1 = _digits(A[:, lo:hi], 2)
        Bc = B8[lo:hi]
        b0 = _reduce31(_mm8(a0, Bc), p)
        b1 = _reduce31(_mm8(a1, Bc), p)
        acc = _reduce31(acc + _reduce31(b0 + w1 * b1, p), p)
    return acc


@annotate("matmul_digits")
def matmul_digits(A: torch.Tensor, B: torch.Tensor, p: int) -> torch.Tensor:
    """Exact (A @ B) mod p; A, B balanced integers of any width, out
    balanced int32.  B may be int8 (one digit): then the d-product
    variant runs."""
    if B.dtype == torch.int8:
        return matmul_digits_i8B(A, B, p)
    F = device_field(p)
    if F.ndigits > 2:
        return _matmul_wide(A, B, p, F)
    n, k = A.shape
    m = B.shape[1]
    w = F.weights
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


@annotate("matmul_digits")
def _matmul_wide(A: torch.Tensor, B: torch.Tensor, p: int,
                 F: DeviceField) -> torch.Tensor:
    """matmul_digits for d == 3 / 4: the d * d digit products summed per
    anti-diagonal in int32 (|sum| <= min(d, s + 1) * kc * 16256 < 2^31 at
    _k_chunk(d)), one diagonal at a time; d == 3 reduces each diagonal in
    int32 and weights it in int64 (< 2^47), d == 4 weights it in int64
    directly (< 2^62); the int64 accumulator of balanced terms is reduced
    every 64 chunks."""
    d = F.ndigits
    n, k = A.shape
    m = B.shape[1]
    acc = torch.zeros((n, m), dtype=torch.int64, device=A.device)
    kc = _k_step(k, m, d)
    for c, lo in enumerate(range(0, k, kc)):
        Ad = _digits(A[:, lo:lo + kc], d, p)
        Bd = _digits(B[lo:lo + kc], d, p)
        for s in range(2 * d - 1):
            part = None
            for d1 in range(max(0, s - d + 1), min(d, s + 1)):
                P = _mm8(Ad[d1], Bd[s - d1])
                part = P if part is None else part.add_(P)
            part = _reduce31(part, p) if d == 3 else part
            acc += dnorm64(part.to(torch.int64) * int(F.weights[s]), p)
        if (c + 1) % 64 == 0:
            acc = dnorm64(acc, p)
    return dnorm64(acc, p).to(torch.int32)


def modp_matmul(A, B, p: int, device="cuda"):
    """Exact (A @ B) mod p, balanced int32 in and out (host-facing):
    numpy arrays or tensors, placed on `device`, where the product stays.
    Runs on the card unless the caller passes device="cpu"; without CUDA
    it raises rather than run on the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("modp_matmul: CUDA is not available; pass "
                           "device='cpu' to run on the host")
    return matmul_digits(torch.as_tensor(A, device=device),
                         torch.as_tensor(B, device=device), p)


def modp_matmul_np(A: np.ndarray, B: np.ndarray, p: int,
                   device="cuda") -> np.ndarray:
    """Host wrapper: numpy in/out."""
    A = np.ascontiguousarray(A, dtype=np.int32)
    B = np.ascontiguousarray(B, dtype=np.int32)
    return modp_matmul(A, B, p, device).cpu().numpy()
