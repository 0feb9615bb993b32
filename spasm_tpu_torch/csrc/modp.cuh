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
// that, p <= 2^32 - 5, for the int32-storage instantiation of B1.
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
// d = 3, < 2^62 at d = 4) and summed in int64 before a reduction.
struct FpWide {
  unsigned long long p, mu, off;
  long long half;
  __host__ __device__ explicit FpWide(long long p_)
      : p(static_cast<unsigned long long>(p_)),
        mu(~0ull / static_cast<unsigned long long>(p_)),
        off((1ull << 63) / static_cast<unsigned long long>(p_) *
            static_cast<unsigned long long>(p_)),
        half((p_ - 1) >> 1) {}
  // Balanced x mod p for x >= -off, off the largest multiple of p <=
  // 2^63 (so any int64 x with |x| <= 2^63 - p): u = x + off lies in
  // [0, 2^64), and the Barrett quotient by mu = floor((2^64 - 1) / p)
  // (__umul64hi) is short by at most 2.
  __device__ __forceinline__ int red(long long x) const {
    const unsigned long long u = static_cast<unsigned long long>(x) + off;
    const unsigned long long q = __umul64hi(u, mu);
    long long r = static_cast<long long>(u - q * p);             // [0, 3p)
    const long long pl = static_cast<long long>(p);
    if (r >= pl) r -= pl;
    if (r >= pl) r -= pl;
    return static_cast<int>(r > half ? r - pl : r);
  }
};

}  // namespace spasm
