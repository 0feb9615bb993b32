// Balanced GF(p) device helpers shared by the port's kernels.
//
// One header for the reductions the TPU kernels each carried a copy of:
// reduce31 is `_reduce31` (spasm_tpu/dense/sweep_pallas.py:47, copied
// at subst_pallas.py:57), used by B1 and B2's pair variant; Fp (below)
// serves B2's cluster variant, B3 and B4, and its Fermat inverse takes the
// place of `_modinv32` (sweep_pallas.py:60).  Scope: the d == 2 digit
// tier, p <= 65279, where 2 * (p/2)^2 < 2^31 so every division-free
// update fits an int32 lane.
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

}  // namespace spasm
