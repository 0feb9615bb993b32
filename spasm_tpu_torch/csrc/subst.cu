// B1: the reduced-basis substitution sweep, for Hopper (sm_90a).
//
// Replaces the Mosaic kernel `_subst_kernel`
// (spasm_tpu/dense/subst_pallas.py:68, called through _subst_call :150
// and run_schedule :254).  It computes, for every basis row k with
// references, in topological order,
//     R[k] <- R[k] - sum_s coef[s] * R[refs[s]]   (mod p, balanced)
// where R[k] already holds row k's scattered free entries.
//
// Order: the rows come grouped in waves.  Rows of one wave never reference
// each other and only reference rows of earlier waves (the topological
// levels of the U rows).
//
// The fact the design rests on: column c of R[k] depends only on column c
// of the rows k references, so a chunk of columns is a complete,
// independent substitution problem for the whole schedule.  The first
// version launched one grid per wave (1135 launches for mk13.b5's
// schedule), and every wave drained the card before the next could
// start.  This one is
// ONE launch per build: the grid is the column chunks, kCols = 64 int16
// columns per block (352 blocks at M = 22528, 320 at M = 20480), and each
// block walks every wave in order with one __syncthreads() between waves.
// No other block ever reads a block's columns: there is no grid barrier,
// no cluster and no flag.  Three 384-thread blocks fit an SM (56
// registers), so all 352 are resident at once on the 132 SMs, ~1024
// threads an SM.
//
// Inside a wave, a row slot of 8 lanes takes one row at a time, rows
// strided over the block's 48 slots; each lane owns 8 consecutive columns
// (one 16-byte load per referenced row).  The row's own load and its
// first kU = 4 reference loads are issued together before the first
// product.  While they are in flight the slot fetches the indices of its
// next row (row id and reference range) -- across the wave barrier too,
// since the index arrays are read-only -- so a row costs one round trip
// for the indices' references and one for R, not three.
//
// Slower or no faster in development, on the same two schedules: 128- and
// 256-column blocks, two rows per slot, and cp.async double buffering of
// the next row into shared memory.  The sweep reads scattered 128-byte row
// segments and is bound by the memory system's rate for them, not by the
// loads in flight.
//
// Traps:
//   * R is read and written in the same launch.  It is never read through
//     `const __restrict__`, __ldg or any other non-coherent path, which
//     may return data from before an earlier wave's store: R's loads are
//     plain loads through a pointer the kernel also stores through.
//   * __syncthreads() makes the block's global stores visible to the
//     block; that is all the ordering the design needs (a block's 128-byte
//     column segment of a row is one cache line no other block touches).
//   * A wave's dependent chain (row loads -> reduce -> store -> barrier)
//     is ~1-2 us, so the schedule's depth (1135 waves on mk13.b5) puts a
//     floor of ~1-2 ms under any wave-ordered design.
//   * L2: all blocks advance through the waves at about the same pace, so
//     the rows of recent waves stay in the 50 MB L2 across blocks.
//
// Storage, and one instantiation of the wave walk for each (a template
// on the arithmetic, no runtime branch):
//   * Narrow, int16 R (p <= 65535, the d = 2 tier and the d = 3 band
//     that int16 still holds): nred products (|coef * R| <= (p/2)^2) are
//     subtracted from the int32 accumulator, which starts balanced, with
//     nred * (p/2)^2 < 2^31 - p, before each Barrett reduction
//     (spasm::reduce31).  Lanes load 8 values.
//   * Wide, int32 R (65535 < p <= 2^32 - 5): the products are formed in
//     64 bits (< 2^47 at d = 3, < 2^62 at d = 4) and summed in int64,
//     nred of them with nred * (p/2)^2 <= 2^63 - 2p (16 at d = 3, 2 at
//     p = 2^32 - 5), before each 64-bit Barrett reduction
//     (spasm::FpWide, __umul64hi).  Lanes load 4 values, so a row slot
//     is 16 lanes and a block has 24 slots; the block still owns 64
//     columns (256-byte row segments).  Two blocks fit an SM.
//
// Bound: memory.  Every live row read and written once and every
// referenced row read once (~0.54 ms on chip_smoke's synthetic schedule,
// ~3 ms on mk13.b5's, int16); the references' re-reads by every row that
// names them put ~5.4 GB (synthetic) and ~18 GB (mk13.b5) on HBM.  Int32
// storage doubles every byte.
#include <cuda_runtime.h>

#include <cstdint>

#include "modp.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kCols = 64;                   // columns per block
constexpr int kU = 4;                       // references loaded per round

// int16 storage: int32 partial sums, reduce31.
struct Narrow {
  using T = int16_t;
  using Acc = int;
  static constexpr int kMinBlocks = 3;
  int p;
  float invp;
  explicit Narrow(int p_) : p(p_), invp(1.0f / static_cast<float>(p_)) {}
  __device__ __forceinline__ Acc prod(int c, T v) const {
    return c * static_cast<int>(v);
  }
  __device__ __forceinline__ int red(Acc x) const {
    return spasm::reduce31(x, p, invp);
  }
};

// int32 storage: int64 partial sums, FpWide.
struct Wide {
  using T = int32_t;
  using Acc = long long;
  static constexpr int kMinBlocks = 2;
  spasm::FpWide f;
  explicit Wide(long long p_) : f(p_) {}
  __device__ __forceinline__ Acc prod(int c, T v) const {
    return static_cast<long long>(c) * v;
  }
  __device__ __forceinline__ int red(Acc x) const { return f.red(x); }
};

template <class T>
__device__ __forceinline__ int4 load16(const T* p) {
  return *reinterpret_cast<const int4*>(p);
}

// The schedule: one int32 array, [bounds (ngroups + 1) | rows (n) |
// ref_ptr (n + 1) | refs (nrefs) | coef (nrefs)].
struct Sched {
  const int32_t* __restrict__ bounds;
  const int32_t* __restrict__ rows;
  const int32_t* __restrict__ ref_ptr;
  const int32_t* __restrict__ refs;
  const int32_t* __restrict__ coef;
  int ngroups;
};

// A slot's row: its wave g, position r (and the wave's end b1), R row and
// reference range [s0, s1).  g == ngroups: none left.
struct Job {
  int g, r, b1, row, s0, s1;
};

// The slot's first row at or after position r of wave g.
__device__ __forceinline__ Job next_job(const Sched& sc, int g, int r, int b1,
                                        int slot) {
  while (g < sc.ngroups && r >= b1) {
    if (++g < sc.ngroups) {
      r = sc.bounds[g] + slot;
      b1 = sc.bounds[g + 1];
    }
  }
  Job j = {g, r, b1, 0, 0, 0};
  if (g < sc.ngroups) {
    j.row = sc.rows[r];
    j.s0 = sc.ref_ptr[r];
    j.s1 = sc.ref_ptr[r + 1];
  }
  return j;
}

template <class Ar>
__global__ void __launch_bounds__(kThreads, Ar::kMinBlocks)
subst_waves(typename Ar::T* R, int M, Sched sc, int nred, const Ar ar) {
  using T = typename Ar::T;
  using Acc = typename Ar::Acc;
  constexpr int kVec = 16 / sizeof(T);      // columns per lane (one load)
  constexpr int kLanes = kCols / kVec;      // lanes per row slot
  constexpr int kSlots = kThreads / kLanes; // row slots per block
  const int slot = threadIdx.x / kLanes;
  const int c = blockIdx.x * kCols + (threadIdx.x % kLanes) * kVec;
  Job cur = next_job(sc, 0, sc.bounds[0] + slot, sc.bounds[1], slot);
  for (int g = 0; g < sc.ngroups; ++g) {
    while (cur.g == g) {                            // slot-uniform
      T* dst = R + static_cast<int64_t>(cur.row) * M + c;
      const int4 raw = load16(dst);
      int cz[kU];
      int4 gv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int s = cur.s0 + u;
        const bool ok = s < cur.s1;
        cz[u] = ok ? sc.coef[s] : 0;
        gv[u] = ok ? load16(R + static_cast<int64_t>(sc.refs[s]) * M + c)
                   : make_int4(0, 0, 0, 0);
      }
      // the next row's indices while this row's loads are in flight
      const Job nx = next_job(sc, cur.g, cur.r + kSlots, cur.b1, slot);
      const T* rv = reinterpret_cast<const T*>(&raw);
      // balanced + nred products between reductions (see the header)
      Acc acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = rv[i];
      int cnt = 0;
      for (int s = cur.s0;;) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (s + u >= cur.s1) break;
          const T* gs = reinterpret_cast<const T*>(&gv[u]);
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] -= ar.prod(cz[u], gs[i]);
          if (++cnt == nred) {
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] = ar.red(acc[i]);
            cnt = 0;
          }
        }
        s += kU;
        if (s >= cur.s1) break;                     // slot-uniform
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const bool ok = s + u < cur.s1;
          cz[u] = ok ? sc.coef[s + u] : 0;
          gv[u] = ok ? load16(R + static_cast<int64_t>(sc.refs[s + u]) * M +
                              c)
                     : make_int4(0, 0, 0, 0);
        }
      }
      int4 out;
      T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < kVec; ++i) ov[i] = static_cast<T>(ar.red(acc[i]));
      *reinterpret_cast<int4*>(dst) = out;
      cur = nx;
    }
    __syncthreads();                    // this wave's stores, to the block
  }
}

template <class Ar>
int launch(void* R, int M, void* sched, int n, int nrefs, int ngroups,
           int nred, const Ar& ar, void* stream) {
  const int32_t* a = static_cast<const int32_t*>(sched);
  Sched sc;
  sc.bounds = a;
  sc.rows = a + ngroups + 1;
  sc.ref_ptr = sc.rows + n;
  sc.refs = sc.ref_ptr + n + 1;
  sc.coef = sc.refs + nrefs;
  sc.ngroups = ngroups;
  subst_waves<Ar><<<M / kCols, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<typename Ar::T*>(R), M, sc, nred, ar);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// R (npad, M) int16 (p <= 65535), M % 64 == 0, rows 16-byte aligned;
// sched the int32 schedule array above, on the card (n rows, nrefs
// references, ngroups >= 1 waves).  One launch.
extern "C" int spasm_subst_waves(void* R, int M, void* sched, int n,
                                 int nrefs, int ngroups, int nred, int p,
                                 void* stream) {
  return launch(R, M, sched, n, nrefs, ngroups, nred, Narrow(p), stream);
}

// The same on int32 R (65535 < p <= 2^32 - 5).  One launch.
extern "C" int spasm_subst_waves_wide(void* R, int M, void* sched, int n,
                                      int nrefs, int ngroups, int nred,
                                      long long p, void* stream) {
  return launch(R, M, sched, n, nrefs, ngroups, nred, Wide(p), stream);
}

// Columns per block: M must be a multiple of it.
extern "C" int spasm_subst_cols() { return kCols; }
