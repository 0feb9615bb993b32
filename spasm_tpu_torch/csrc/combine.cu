// B12: the gather-combine that forms the rank finisher's blocks at d >= 3,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package forms a block in `_form_chunk`
// (spasm_tpu/dense/reduced.py:149) by materializing the (S, K, M) gather
// of the referenced R rows and summing it in XLA (`_ref_combine`, :54).
// The port's torch version (dense/reduced.py `_ref_combine`) walks the K
// slots one at a time, and above the d = 2 tier each slot is a gather, two
// widenings, a product, a reduction and an add over the whole (S, M)
// tile in int64.  A profile of mk12.b4's rank at 2^32 - 5 put that loop
// at about 19 s of a 35 s call: its rows are a Schur complement's (~1,060
// slots a row after padding, most of them dead), and every slot, dead or
// not, cost nine full-tile passes.  This kernel does, in one launch,
//     X[b, c] <- X[b, c] - sum_k V[b, k] R[refs[b, k], c]   (mod p)
// for rows b < S and columns c < w, balanced, in place over X (which holds
// the scattered entries Xb), skipping dead slots (refs == dead, the zero
// row, or V == 0), and zeroes column w - 1 when asked (the dead column of
// the compact domain).
//
// Design:
//   * A block owns kRows rows and one column tile of 256 lanes x 16 bytes
//     of R (1024 int32 columns, 2048 int16).  For each row it compacts the
//     live slots, kChunk at a time, into shared memory (a warp ballot and
//     one shared atomic a warp), then every lane walks the compacted list
//     with no branch on the data: one 16-byte load of R per live slot, kU
//     of them in flight.  A row whose slots are all dead costs the slot
//     reads and nothing else.
//   * Products are formed in 64 bits (< 2^62 at d = 4, < 2^47 at d = 3)
//     and folded with spasm::FpWide::part every nred of them (the
//     wrapper's nred_wide(p): 2 at 2^32 - 5, 16 at d = 3) into an int64
//     accumulator seeded with X; one FpWide::red at the end.  The balanced
//     residue is unique, so the result is the torch loop's bit for bit.
//   * The grid is column-tile-major (blockIdx.x the rows, .y the tile), so
//     the blocks in flight read one column tile of R: the rows a block's
//     pivots reference (~5.8k in mk12.b4's round 1) take ~24 MB of it,
//     which the 50 MB L2 holds, and R comes from HBM about once a block.
// Bound: bytes, counted once each: X read and written (S w 4 bytes each)
// and the referenced rows of R (distinct live refs x w x 2 or 4 bytes);
// the loads themselves (live slots x 16 bytes a lane) come from L2.
// Operations: live slots x w modular products, each a 32 x 32 -> 64-bit
// multiply and a 64-bit subtract, plus a fold (two FP64 conversions and a
// 64-bit multiply) every nred products.
#include <cstdint>

#include "modp.cuh"

namespace {

constexpr int kThreads = 256;   // lanes of a row (one column tile)
constexpr int kRows = 4;        // rows a block walks
constexpr int kChunk = 1024;    // slots compacted at a time
constexpr int kU = 4;           // R loads in flight a lane

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_combine(int32_t* __restrict__ X, const T* __restrict__ R, int w,
               const int64_t* __restrict__ refs,
               const int32_t* __restrict__ V, int S, int K, long long dead,
               int nred, int zero_last, const spasm::FpWide f) {
  constexpr int kVec = 16 / sizeof(T);          // columns a lane
  __shared__ int s_ref[kChunk];
  __shared__ int s_v[kChunk];
  __shared__ int s_n;
  const int c = (blockIdx.y * kThreads + threadIdx.x) * kVec;
  const bool in = c < w;                        // w % kVec == 0
  const int lane = threadIdx.x & 31;
  for (int rr = 0; rr < kRows; ++rr) {
    const int b = blockIdx.x * kRows + rr;
    if (b >= S) break;                          // block-uniform
    int32_t* xrow = X + static_cast<int64_t>(b) * w + c;
    long long acc[kVec];
    if (in) {
#pragma unroll
      for (int h = 0; h < kVec / 4; ++h) {
        const int4 x4 = reinterpret_cast<const int4*>(xrow)[h];
        acc[4 * h] = x4.x;
        acc[4 * h + 1] = x4.y;
        acc[4 * h + 2] = x4.z;
        acc[4 * h + 3] = x4.w;
      }
    }
    const int64_t* rrefs = refs + static_cast<int64_t>(b) * K;
    const int32_t* rv = V + static_cast<int64_t>(b) * K;
    int cnt = 0;                                // products since a fold
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      if (threadIdx.x == 0) s_n = 0;
      __syncthreads();
      for (int j = threadIdx.x; j < kChunk; j += kThreads) {
        const int k = k0 + j;
        long long r = dead;
        int v = 0;
        if (k < K) {
          r = rrefs[k];
          v = rv[k];
        }
        const bool live = r != dead && v != 0;
        const unsigned m = __ballot_sync(0xffffffffu, live);
        int at = 0;
        if (lane == 0 && m) at = atomicAdd(&s_n, __popc(m));
        at = __shfl_sync(0xffffffffu, at, 0);
        if (live) {
          const int pos = at + __popc(m & ((1u << lane) - 1u));
          s_ref[pos] = static_cast<int>(r);
          s_v[pos] = v;
        }
      }
      __syncthreads();
      const int n = s_n;
      if (in) {
        for (int i = 0; i < n; i += kU) {
          int4 g[kU];
          int cv[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const bool ok = i + u < n;
            cv[u] = ok ? s_v[i + u] : 0;
            g[u] = ok ? __ldg(reinterpret_cast<const int4*>(
                            R + static_cast<int64_t>(s_ref[i + u]) * w + c))
                      : make_int4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            if (i + u >= n) break;
            const T* gs = reinterpret_cast<const T*>(&g[u]);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              acc[e] -= static_cast<long long>(cv[u]) * gs[e];
            if (++cnt == nred) {
#pragma unroll
              for (int e = 0; e < kVec; ++e) acc[e] = f.part(acc[e]);
              cnt = 0;
            }
          }
        }
      }
      __syncthreads();                          // s_ref, s_n reused
    }
    if (in) {
      int out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = f.red(acc[e]);
      if (zero_last && c + kVec == w) out[kVec - 1] = 0;
#pragma unroll
      for (int h = 0; h < kVec / 4; ++h)
        reinterpret_cast<int4*>(xrow)[h] =
            make_int4(out[4 * h], out[4 * h + 1], out[4 * h + 2],
                      out[4 * h + 3]);
    }
  }
}

}  // namespace

// X (S, w) int32 balanced, updated in place; R (rows, w) int16 (r16 != 0)
// or int32, balanced; refs (S, K) int64 R row ids, V (S, K) int32
// balanced; all contiguous on one card, w % 8 == 0, X and R 16-byte
// aligned.  Slots with refs == dead or V == 0 are skipped.  nred: products
// between folds (nred * (p/2)^2 <= 2^63 - 2p).  One launch.
extern "C" int spasm_gather_combine(void* X, const void* R, int r16, int w,
                                    const void* refs, const void* V, int S,
                                    int K, long long dead, int nred,
                                    long long p, int zero_last,
                                    void* stream) {
  const int cols = kThreads * (r16 ? 8 : 4);
  const dim3 grid((S + kRows - 1) / kRows, (w + cols - 1) / cols);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const spasm::FpWide f(p);
  if (r16)
    gather_combine<int16_t><<<grid, kThreads, 0, st>>>(
        static_cast<int32_t*>(X), static_cast<const int16_t*>(R), w,
        static_cast<const int64_t*>(refs), static_cast<const int32_t*>(V), S,
        K, dead, nred, zero_last, f);
  else
    gather_combine<int32_t><<<grid, kThreads, 0, st>>>(
        static_cast<int32_t*>(X), static_cast<const int32_t*>(R), w,
        static_cast<const int64_t*>(refs), static_cast<const int32_t*>(V), S,
        K, dead, nred, zero_last, f);
  return static_cast<int>(cudaGetLastError());
}
