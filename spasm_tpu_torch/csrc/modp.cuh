// Balanced GF(p) device helpers shared by the port's kernels.
//
// One header for the reductions the TPU kernels each carried a copy of:
// reduce31 is `_reduce31` (spasm_tpu/dense/sweep_pallas.py:47, copied
// at subst_pallas.py:57), used by B1 and B2's pair variant; Fp (below)
// serves B2's cluster variant, B3 and B4, and its Fermat inverse takes the
// place of `_modinv32` (sweep_pallas.py:60).  Scope of both: the d == 2
// digit tier, p <= 65279, where 2 * (p/2)^2 < 2^31 so every
// division-free update fits an int32 lane (reduce31 also serves B1's
// int16 storage up to p = 65535).  FpWide (below) is the field above
// that, p <= 2^32 - 5, for B1 wide (the int32-storage kernel).
#pragma once

#include <cstdint>

namespace spasm {

// Balanced representative of x mod p for ANY int32 x: two rounds of
// float32-reciprocal Barrett (round 1 leaves |r| <= 384 + p/2, round 2
// leaves |r| <= 0.52 p) and two conditional corrections.  q * p may
// wrap; it is formed in unsigned arithmetic, where the wrap cancels.
__device__ __forceinline__ int reduce31(int x, int p, float invp) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = __float2int_rn(static_cast<float>(x) * invp);
    x = static_cast<int>(static_cast<unsigned>(x) -
                         static_cast<unsigned>(q) * static_cast<unsigned>(p));
  }
  const int half = (p - 1) >> 1;
  if (x > half) x -= p;
  if (x < -half) x += p;
  return x;
}

// The field with its reduction constants, for the redesigned kernels
// (B2's cluster variant, B3 and B4), which reduce on the integer and FP64
// pipes and keep the float32 conversions of reduce31 (a quarter-rate
// unit) off their paths.
struct Fp {
  int p, half;
  unsigned mu, off;
  double inv;
  __device__ explicit Fp(int p_)
      : p(p_),
        half((p_ - 1) >> 1),
        mu(0xffffffffu / static_cast<unsigned>(p_)),
        off(0x80000000u / static_cast<unsigned>(p_) *
            static_cast<unsigned>(p_)),
        inv(1.0 / p_) {}
  // Balanced x mod p for -off <= x < 2^32 - off, off the largest multiple
  // of p <= 2^31 (so any |x| <= 2^31 - p, which holds v * a - g * b on
  // balanced operands: (p - 1)^2 / 2): x + off lies in [0, 2^32), and the
  // Barrett quotient by mu = floor((2^32 - 1) / p) is short by at most 2.
  __device__ __forceinline__ int red(int x) const {
    const unsigned u = static_cast<unsigned>(x) + off;
    const unsigned q = __umulhi(u, mu);
    int r = static_cast<int>(u - q * static_cast<unsigned>(p));   // [0, 3p)
    if (r >= p) r -= p;
    if (r >= p) r -= p;
    return r > half ? r - p : r;
  }
  // Balanced x mod p for |x| < 2^52 (sums of products of balanced values):
  // the quotient rounded in FP64 is off by at most one, at a tie.
  __device__ __forceinline__ int red64(long long x) const {
    const long long q = __double2ll_rn(static_cast<double>(x) * inv);
    int r = static_cast<int>(x - q * p);
    if (r > half) r -= p;
    if (r < -half) r += p;
    return r;
  }
  // Fermat inverse of a balanced a (0 maps to 0).
  __device__ __forceinline__ int inverse(int a) const {
    int result = 1;
    for (unsigned e = static_cast<unsigned>(p - 2); e; e >>= 1) {
      if (e & 1u) result = red(result * a);
      a = red(a * a);
    }
    return result;
  }
};

// The wide field, 65535 < p <= 2^32 - 5 (B1 on int32 storage): balanced
// values fit int32, products of two are formed in 64 bits (< 2^47 at
// d = 3, < 2^62 at d = 4) and summed in int64 before a reduction.  The
// quotient comes from FP64: for |x| <= 2^63 - p, x rounded to a double
// (off by at most 2^9), times 1/p rounded, rounded again, lies within
// 2560 / p of x / p, so q = rint(x * (1/p)) is x's nearest quotient or
// one off it, and x - q p lies within p/2 + 2560 (`part`, what a partial
// sum needs); one correction on each side makes it balanced (`red`).
// Two conversions on the FP64 pipe and one 64-bit multiply: a 64-bit
// Barrett reduction needs __umul64hi, four 32-bit multiplies here.
struct FpWide {
  long long p, half;
  double inv;
  __host__ __device__ explicit FpWide(long long p_)
      : p(p_), half((p_ - 1) >> 1), inv(1.0 / static_cast<double>(p_)) {}
  // x - q p, |.| <= p/2 + 2560, for |x| <= 2^63 - p.
  __device__ __forceinline__ long long part(long long x) const {
    return x - __double2ll_rn(static_cast<double>(x) * inv) * p;
  }
  // Balanced x mod p for |x| <= 2^63 - p.
  __device__ __forceinline__ int red(long long x) const {
    long long r = part(x);
    if (r > half) r -= p;
    if (r < -half) r += p;
    return static_cast<int>(r);
  }
};

}  // namespace spasm
