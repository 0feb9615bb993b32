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
// start.  This one is ONE launch per build: each block owns column
// chunks of kCols = 64 columns and walks every wave in order with one
// __syncthreads() between waves.  No other block ever reads a block's
// columns: there is no grid barrier, no cluster and no flag.  Neither is
// there a second round of blocks: a block that starts only after others
// have walked every wave walks them alone, with the card nearly idle.
//
// Storage, and one kernel for each:
//   * int16 R (p <= 65535, the d = 2 tier and the d = 3 band that int16
//     still holds): `subst_waves<Narrow>`, one block per chunk (352
//     blocks at M = 22528, 320 at M = 20480).  Three 384-thread blocks
//     fit an SM (53 registers), so all 352 are resident at once on the
//     132 SMs, ~1024 threads an SM.  A row slot of 8 lanes takes one row
//     at a time, rows strided over the block's 48 slots; each lane owns
//     8 consecutive columns (one 16-byte load per referenced row).  nred
//     products (|coef * R| <= (p/2)^2) are subtracted from the int32
//     accumulator, which starts balanced, with nred * (p/2)^2 < 2^31 - p,
//     before each Barrett reduction (spasm::reduce31).
//   * int32 R (65535 < p <= 2^32 - 5): `subst_wide`, counted as "B1
//     wide".  Lanes load 4 values, so a row slot is 16 lanes (a 256-byte
//     row segment), a block has 24 slots.  See its own note below.
//
// Inside a wave, the row's own load and its first kU = 4 reference loads
// are issued together before the first product.  While they are in
// flight the slot fetches the indices of its next row (row id and
// reference range) -- across the wave barrier too, since the index
// arrays are read-only -- so a row costs one round trip for the indices'
// references and one for R, not three.
//
// Slower or no faster in development (int16), on the same two schedules:
// 128- and 256-column blocks, two rows per slot, and cp.async double
// buffering of the next row into shared memory.  The sweep reads scattered
// 128-byte row segments and is bound by the memory system's rate for
// them, not by the loads in flight.
//
// Traps:
//   * R is read and written in the same launch.  It is never read through
//     `const __restrict__`, __ldg or any other non-coherent path, which
//     may return data from before an earlier wave's store: R's loads are
//     plain loads (int16) or L2 loads, __ldcg (int32), through a pointer
//     the kernel also stores through.
//   * __syncthreads() makes the block's global stores visible to the
//     block; that is all the ordering the design needs (a block's column
//     segment of a row is a whole line no other block touches).
//   * A wave's dependent chain (row loads -> reduce -> store -> barrier)
//     is ~1-2 us, so the schedule's depth (1135 waves on mk13.b5) puts a
//     floor of ~1-2 ms under any wave-ordered design.
//   * L2: all blocks advance through the waves at about the same pace, so
//     the rows of recent waves stay in the 50 MB L2 across blocks.
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

// B1 wide, the int32-storage walk (65535 < p <= 2^32 - 5).
//
// What bound it when it was an instantiation of the int16 walk
// (mk12.b4's round-0 schedule, 320 chunks at M = 20480, an H100 SXM):
// residency.  Its int64 accumulators and four 16-byte loads in flight
// took 66 registers, so two blocks fitted an SM: 264 ran at once and 56
// walked all 272 waves after them, alone (about 4.1 ms at M = 20480
// against 2.35 ms at M = 16896 = 64 x 264, every block resident;
// b1_wide_ab.py).  Then the arithmetic: at p = 2^32 - 5 two products
// fill an int64 partial sum, and a 64-bit Barrett reduction
// (__umul64hi, four 32-bit multiplies on this card) ran after every
// second product.
//
// What this kernel does about it:
//   * kWideMinBlocks = 3 caps it at 56 registers with no spills, so three
//     blocks fit an SM: 396 resident on 132 SMs.
//   * The grid is resident whole, whatever M: the wrapper launches G <=
//     blocks per SM x SMs blocks, and block b owns the chunks b, b + G,
//     b + 2G, ... (`mine` of them: the wrapper makes every block's count
//     per or per - 1, `wide_plan` in dense/subst.py).  A wave's jobs are
//     its (row, owned chunk) pairs, t = row position * mine + chunk,
//     strided over the block's 24 slots.
//   * spasm::FpWide reduces through an FP64 quotient (two conversions and
//     a 64-bit multiply); a partial sum between products keeps x - q p
//     unbalanced (|.| <= p/2 + 2560), only the stored value is balanced.
//   * The products per partial sum follow the schedule's largest |coef|
//     (the wrapper's nred): 16 for the +-1 entries of a boundary map at
//     any p, so a row of mk12.b4 reduces once at 2^32 - 5 as at 65537.
//   * R is loaded through L2 (__ldcg): a block's row segments are read by
//     no other SM, so L1 keeps nothing another load would find.
// Bound: bytes still.  mk12.b4's schedule moves 4.44 GB if every row is
// read once (1.33 ms at 3.35 TB/s), 8.9 GB with every reference re-read,
// of which an LRU model of the 50 MB L2 over the processing order leaves
// ~7.2 GB for HBM; the kernel's ~2.7 ms is that at ~2.7 TB/s.
// Slower in development: balanced column ranges that split 128-byte
// lines between blocks, one (row, 16-byte segment) job per thread, a
// per-thread cp.async ring of the next rows, and Shoup products (a
// precomputed word per coefficient) summed lazily.
constexpr int kWideMinBlocks = 3;

struct WideJob {
  int g, t, b0, nj, row, s0, s1, c;     // wave g: jobs [0, nj) from row b0
};

// The slot's first job at or after index t of wave g; c the lane's first
// column.
__device__ __forceinline__ WideJob next_wide_job(const Sched& sc, int g,
                                                 int t, int b0, int nj,
                                                 int slot, int mine,
                                                 int lane_c) {
  while (g < sc.ngroups && t >= nj) {
    if (++g < sc.ngroups) {
      t = slot;
      b0 = sc.bounds[g];
      nj = (sc.bounds[g + 1] - b0) * mine;
    }
  }
  WideJob j = {g, t, b0, nj, 0, 0, 0, 0};
  if (g < sc.ngroups) {
    int q = t, k = 0;                   // row position, owned chunk
    if (mine > 1) {
      q = t / mine;
      k = t - q * mine;
    }
    const int r = b0 + q;
    j.row = sc.rows[r];
    j.s0 = sc.ref_ptr[r];
    j.s1 = sc.ref_ptr[r + 1];
    j.c = (blockIdx.x + k * gridDim.x) * kCols + lane_c;
  }
  return j;
}

__device__ __forceinline__ int4 load_l2(const int32_t* p) {
  return __ldcg(reinterpret_cast<const int4*>(p));
}

__global__ void __launch_bounds__(kThreads, kWideMinBlocks)
subst_wide(int32_t* R, int M, Sched sc, int nred, const spasm::FpWide f) {
  constexpr int kVec = 4;                   // columns per lane (one load)
  constexpr int kLanes = kCols / kVec;      // lanes per row slot
  constexpr int kSlots = kThreads / kLanes; // row slots per block
  const int slot = threadIdx.x / kLanes;
  const int lane_c = (threadIdx.x % kLanes) * kVec;
  const int mine = (M / kCols - blockIdx.x + gridDim.x - 1) / gridDim.x;
  WideJob cur = next_wide_job(sc, 0, slot, sc.bounds[0],
                              (sc.bounds[1] - sc.bounds[0]) * mine, slot,
                              mine, lane_c);
  for (int g = 0; g < sc.ngroups; ++g) {
    while (cur.g == g) {                            // slot-uniform
      const int c = cur.c;
      int32_t* dst = R + static_cast<int64_t>(cur.row) * M + c;
      const int4 raw = load_l2(dst);
      int cz[kU];
      int4 gv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int s = cur.s0 + u;
        const bool ok = s < cur.s1;
        cz[u] = ok ? sc.coef[s] : 0;
        gv[u] = ok ? load_l2(R + static_cast<int64_t>(sc.refs[s]) * M + c)
                   : make_int4(0, 0, 0, 0);
      }
      // the next job's indices while this row's loads are in flight
      const WideJob nx = next_wide_job(sc, cur.g, cur.t + kSlots, cur.b0,
                                       cur.nj, slot, mine, lane_c);
      const int32_t* rv = reinterpret_cast<const int32_t*>(&raw);
      // nred products between partial reductions: nred * cmax * (p/2)
      // <= 2^63 - 2p, cmax the schedule's largest |coef| (nred_wide in
      // dense/subst.py), keeps every partial sum within FpWide's
      // |x| <= 2^63 - p
      long long acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = rv[i];
      int cnt = 0;
      for (int s = cur.s0;;) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (s + u >= cur.s1) break;
          const int32_t* gs = reinterpret_cast<const int32_t*>(&gv[u]);
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            acc[i] -= static_cast<long long>(cz[u]) * gs[i];
          if (++cnt == nred) {
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] = f.part(acc[i]);
            cnt = 0;
          }
        }
        s += kU;
        if (s >= cur.s1) break;                     // slot-uniform
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const bool ok = s + u < cur.s1;
          cz[u] = ok ? sc.coef[s + u] : 0;
          gv[u] = ok ? load_l2(R + static_cast<int64_t>(sc.refs[s + u]) *
                                       M + c)
                     : make_int4(0, 0, 0, 0);
        }
      }
      int4 out;
      int32_t* ov = reinterpret_cast<int32_t*>(&out);
#pragma unroll
      for (int i = 0; i < kVec; ++i) ov[i] = f.red(acc[i]);
      *reinterpret_cast<int4*>(dst) = out;
      cur = nx;
    }
    __syncthreads();                    // this wave's stores, to the block
  }
}

// The schedule's five arrays inside the one int32 array the wrapper sends.
Sched schedule(void* sched, int n, int nrefs, int ngroups) {
  const int32_t* a = static_cast<const int32_t*>(sched);
  Sched sc;
  sc.bounds = a;
  sc.rows = a + ngroups + 1;
  sc.ref_ptr = sc.rows + n;
  sc.refs = sc.ref_ptr + n + 1;
  sc.coef = sc.refs + nrefs;
  sc.ngroups = ngroups;
  return sc;
}

}  // namespace

// R (npad, M) int16 (p <= 65535), M % 64 == 0, rows 16-byte aligned;
// sched the int32 schedule array above, on the card (n rows, nrefs
// references, ngroups >= 1 waves).  One launch.
extern "C" int spasm_subst_waves(void* R, int M, void* sched, int n,
                                 int nrefs, int ngroups, int nred, int p,
                                 void* stream) {
  subst_waves<Narrow><<<M / kCols, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(R), M, schedule(sched, n, nrefs, ngroups), nred,
      Narrow(p));
  return static_cast<int>(cudaGetLastError());
}

// The same on int32 R (65535 < p <= 2^32 - 5), on grid blocks (at most
// the resident ones, spasm_subst_blocks_per_sm(1) x SMs; each owns the
// chunks b, b + grid, ...).  One launch.
extern "C" int spasm_subst_waves_wide(void* R, int M, void* sched, int n,
                                      int nrefs, int ngroups, int nred,
                                      long long p, int grid, void* stream) {
  subst_wide<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(R), M, schedule(sched, n, nrefs, ngroups), nred,
      spasm::FpWide(p));
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the int16 (wide == 0) or int32 kernel
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), negative on error.
extern "C" int spasm_subst_blocks_per_sm(int wide) {
  int b = 0;
  const cudaError_t e =
      wide ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, subst_wide,
                                                           kThreads, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &b, subst_waves<Narrow>, kThreads, 0);
  return e ? -static_cast<int>(e) : b;
}

// Columns per block: M must be a multiple of it.
extern "C" int spasm_subst_cols() { return kCols; }
