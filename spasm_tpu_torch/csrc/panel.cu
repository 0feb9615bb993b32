// B4: the panel kernel of the blocked column-sweep RREF / PLUQ, for
// Hopper (sm_90a).
//
// Replaces `_panel_kernel` (spasm_tpu/dense/sweep_pallas.py:77,
// pallas_call at :210), the latency-bound part of one panel step of
// `_eliminate` (spasm_tpu/dense/elim.py:199-258).  On an (n, 64) int32
// column panel P of S (read through S's row stride, no transpose copy):
//   1. division-free pivot discovery: for t = 0..63, the first row not
//      yet pivotal with P[r, t] != 0 becomes slot t's pivot, and every
//      other available row with a nonzero in column t is updated
//      P[i] <- v * P[i] - P[i, t] * P[r] (v = P[r, t]), which keeps zero
//      patterns exactly (|.| <= 2 (p/2)^2 < 2^31 for p <= 65279);
//   2. the pivot minor W[t, b] = P0[r_t, b] from the ORIGINAL panel,
//      identity rows / columns on empty slots;
//   3. [W | I] by 64 division-free steps: all rows (RREF, Gauss-Jordan)
//      or the rows below the diagonal (LU, forward elimination);
//   4. one batched Fermat inverse of the diagonal: Z = W^-1 (RREF) or
//      Zlu = D^-1 Lambda^-1 (LU);
//   5. LU: Vinv, the inverse of the unit-upper D^-1 Omega.
// Outputs lrows, lhas, is_piv', Z (and Vinv) are unique, so any exact
// route gives the plain torch version's integers (dense/panel.py).
//
// Bound on this card: 64 + 64 (+ 64) dependent steps, not bytes (the
// panel at (4608, 64) is 1.18 MB: 0.35 us at 3.35 TB/s).  The first
// version, one cooperative launch with the working panel in L2, paid a
// grid barrier and two L2 round trips per discovery step and ran the
// minor on 256 threads of one block: 0.78-0.83 ms whatever n and mode.
// This design, one launch either way:
//   * cluster variant (n <= kCluster * kRowsMax = 24576): one cluster of
//     kCluster = 16 blocks (non-portable size) keeps the working panel in
//     distributed shared memory as int16 (every balanced residue of
//     p <= 65279 fits), transposed (64, R) per block so a step's column
//     scan is conflict-free; it is loaded coalesced (a warp reads a
//     row's 256 B).  Step t: each block finds its first available row
//     and sends it (index and values, 144 B) to all 16 blocks with TMA
//     bulk copies that complete on the receivers' mbarriers; each block
//     then takes the minimum row and its values from its own shared
//     memory and updates its rows, up to 8 threads per row.  No grid or
//     cluster barrier and no L2 round trip per step;
//   * cooperative variant (taller panels): the first version's discovery
//     (a thread per row, one grid barrier per step, panel in L2);
//   * the minor (both variants, one block of 1024 threads): the 64 steps
//     touch only the 65 live columns [t, t + 64] of [W | I] (columns left
//     of t hold just their diagonal, columns right of 64 + t just the
//     identity, which are scaled apart); row t and column t of a step
//     come from a snapshot its predecessor wrote, so a step is one block
//     barrier; the diagonal's inverses run on 64 threads; Vinv comes in
//     16 x 16 blocks: the diagonal ones by backward elimination, all four
//     at once (15 barriers), the others by block back substitution (6).
// What bounds it now (chip_smoke.py's phase split): the discovery's 64
// exchanges (~1.8 us each with little work) plus the row updates, and
// the minor's 64 x 65 element updates per step, bound by the instruction
// rate of one SM.
// Reductions use spasm::Fp (integer Barrett, FP64 for int64 sums).  A
// template flag adds clock64 / globaltimer stamps at the phase borders,
// read by `spasm_panel_stamped` (chip_smoke.py's phase split).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"
#include "device.cuh"
#include "modp.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNB = 64;
constexpr int kW = 2 * kNB;             // [W | I]
constexpr int kLd = kW + 1;             // padded: column reads hit all banks
constexpr int kCluster = 16;            // blocks per cluster
constexpr int kThreads = 1024;          // both variants
constexpr int kRowsMax = 1536;          // rows per block of the cluster
// stamps: start, preamble, discovery, minor steps, inverse and Z, Vinv
constexpr int kStamps = 6;

template <bool kStamp>
__device__ __forceinline__ void stamp(long long* out, int k) {
  if (kStamp && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    out[k] = clock64();
    out[kStamps + k] = static_cast<long long>(ns);
  }
}

constexpr int kVB = 16;                 // Vinv's diagonal block size

struct MinorShared {
  int M[kNB * kLd];
  int pr[2][kNB + 1];                   // row t of the live columns
  int g[2][kNB];                        // column t (the multipliers)
  int d[kNB];
  int T[3][kVB * kVB];                  // Vinv's off-diagonal sums
};

// Phases 2-5 on one block of 1024 threads; lr (shared) holds the pivot row
// per slot, -1 for none.  Step t of [W | I] reads row t and column t as a
// snapshot (pr, g) that the threads of step t - 1 wrote as they updated
// those elements, so every other element is read and written by one
// thread only, and a step costs one barrier.  Thread tid serves the
// elements (r + 16 m, t + q) of the live columns, r = tid / 64, q = tid %
// 64, m < 4; threads 0-63 also take column t + 64 of row tid and the
// dead entries of row tid.
template <bool kStamp>
__device__ void minor(const int* __restrict__ P, long long ld, const int* lr,
                      int* lrows, unsigned char* lhas, int* Z, int* Vinv,
                      MinorShared& s, const spasm::Fp& F, bool rref,
                      long long* stamps) {
  const int tid = threadIdx.x;          // blockDim.x == 1024
  const int r0 = tid >> 6;
  const int q = tid & (kNB - 1);
  if (tid < kNB) {
    lrows[tid] = lr[tid];
    lhas[tid] = lr[tid] >= 0;
  }
  // the next step's multiplier of row i, from its new value x in column t
  auto gnext = [&](int i, int t, int x) {
    if (rref) return i == t ? F.red(x - 1) : x;
    return i <= t ? 0 : x;
  };
  for (int idx = tid; idx < kNB * kW; idx += kThreads) {
    const int i = idx >> 7;
    const int c = idx & (kW - 1);
    int x;
    if (c < kNB)
      x = (lr[i] >= 0 && lr[c] >= 0)
              ? P[static_cast<long long>(lr[i]) * ld + c]
              : (i == c);
    else
      x = (c - kNB == i);
    s.M[i * kLd + c] = x;
    if (i == 0 && c <= kNB) s.pr[0][c] = x;
    if (c == 0) s.g[0][i] = gnext(i, 0, x);
  }
  __syncthreads();
  for (int t = 0; t < kNB; ++t) {
    const int b = t & 1;
    const int* pr = s.pr[b];
    const int* g = s.g[b];
    int* prn = s.pr[b ^ 1];
    int* gn = s.g[b ^ 1];
    const int v = pr[0];
    const bool more = t + 1 < kNB;
#pragma unroll
    for (int m = 0; m <= 4; ++m) {
      int i, qq;
      if (m < 4) {
        i = r0 + 16 * m;
        qq = q;
      } else {                          // column t + 64
        if (tid >= kNB) break;
        i = tid;
        qq = kNB;
      }
      if (!rref && i <= t) continue;
      int* e = &s.M[i * kLd + t + qq];
      const int x = F.red(v * *e - g[i] * pr[qq]);
      *e = x;
      if (more) {
        if (i == t + 1 && qq >= 1) prn[qq - 1] = x;
        if (qq == 1) gn[i] = gnext(i, t + 1, x);
      }
    }
    if (tid < kNB) {
      if (!rref && tid <= t && more) gn[tid] = 0;   // rows not updated
      if (rref && tid < t) {            // dead: left of t, the diagonal
        int* e = &s.M[tid * kLd + tid];
        *e = F.red(v * *e);
      }
      if (tid > t) {                    // dead: right of 64 + t, identity
        int* e = &s.M[tid * kLd + kNB + tid];
        *e = F.red(v * *e);
        if (tid == t + 1) prn[kNB] = *e;
      }
    }
    __syncthreads();
  }
  stamp<kStamp>(stamps, 3);
  if (tid < kNB) s.d[tid] = F.inverse(s.M[tid * kLd + tid]);
  __syncthreads();
  for (int idx = tid; idx < kNB * kNB; idx += kThreads) {
    const int i = idx >> 6;
    const int j = idx & (kNB - 1);
    Z[idx] = F.red(s.d[i] * s.M[i * kLd + kNB + j]);
    // LU: the left half becomes Vup = D^-1 Omega (unit upper); the right
    // half, Z being out, starts Vinv as I
    if (!rref) {
      s.M[i * kLd + j] = F.red(s.d[i] * s.M[i * kLd + j]);
      s.M[i * kLd + kNB + j] = i == j;
    }
  }
  __syncthreads();
  stamp<kStamp>(stamps, 4);
  if (rref) {
    stamp<kStamp>(stamps, 5);
    return;
  }
  // Vinv = Vup^-1 (unit upper) in 16 x 16 blocks X_ij, in the right
  // half (R, I at first).  The diagonal blocks by backward elimination of
  // [V_ii | I], all four at once: at local step t the multipliers are
  // V_ii's own column t (the rows below t are already unit rows), so rows
  // i < t take R[i] -= V[i, t] R[t] on columns >= t; one barrier per step.
  {
    const int blk = tid >> 8;           // 4 blocks x 256 threads
    const int il = (tid >> 4) & (kVB - 1), ql = tid & (kVB - 1);
    const int i = blk * kVB + il, q = blk * kVB + ql;
    for (int t = kVB - 1; t > 0; --t) {
      if (il < t && ql >= t) {
        const int rt = blk * kVB + t;
        int* e = &s.M[i * kLd + kNB + q];
        *e = F.red(*e - s.M[i * kLd + rt] * s.M[rt * kLd + kNB + q]);
      }
      __syncthreads();
    }
  }
  // then X_ij = -X_ii sum_{i < k <= j} V_ik X_kj, by distance j - i = 1,
  // 2, 3 (3, 2, 1 blocks): two barriers per distance
  for (int dist = 1; dist < kNB / kVB; ++dist) {
    const int np = kNB / kVB - dist;
    const int pi = tid >> 8;            // pair: block row pi, column pi + dist
    const int a = (tid >> 4) & (kVB - 1), c = tid & (kVB - 1);
    const int bi = pi * kVB, bj = (pi + dist) * kVB;
    if (pi < np) {
      long long acc = 0;
      for (int k = bi + kVB; k < bj + kVB; ++k)
        acc += static_cast<long long>(s.M[(bi + a) * kLd + k]) *
               s.M[k * kLd + kNB + bj + c];
      s.T[pi][a * kVB + c] = F.red64(acc);
    }
    __syncthreads();
    if (pi < np) {
      long long acc = 0;
#pragma unroll
      for (int k = 0; k < kVB; ++k)
        acc += static_cast<long long>(s.M[(bi + a) * kLd + kNB + bi + k]) *
               s.T[pi][k * kVB + c];
      s.M[(bi + a) * kLd + kNB + bj + c] = -F.red64(acc);
    }
    __syncthreads();
  }
  for (int idx = tid; idx < kNB * kNB; idx += kThreads)
    Vinv[idx] = s.M[(idx >> 6) * kLd + kNB + (idx & (kNB - 1))];
  stamp<kStamp>(stamps, 5);
}

// ---- cluster variant -------------------------------------------------

// Row stride of a block's transposed panel: R rounded up so that it is an
// odd number of 32-bit words (column-wise stores by a warp spread over
// the banks).
__host__ __device__ inline int cluster_rld(int R) {
  int r = (R + 1) & ~1;
  if (((r >> 1) & 1) == 0) r += 2;
  return r;
}

__host__ __device__ inline size_t cluster_smem(int R) {
  const size_t pan = sizeof(short) * kNB * cluster_rld(R) + R;
  const size_t m = sizeof(MinorShared);
  return ((pan > m ? pan : m) + 15) & ~static_cast<size_t>(15);
}

// The exchange of a discovery step (cluster.cuh): each block's candidate
// (its first available row with a nonzero in column t, or none) as one
// 144-byte message, sent to every block of the cluster.
struct __align__(16) Candidate {
  int row;                              // n: none
  int pad[3];
  short val[kNB];
};

template <bool kStamp>
__global__ void __launch_bounds__(kThreads, 1)
panel_cluster(const int* __restrict__ P, long long ld, int n, int R,
              const unsigned char* __restrict__ piv_in, int* lrows,
              unsigned char* lhas, unsigned char* piv_out, int* Z, int* Vinv,
              int p, int rref, long long* stamps) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int4 smem4[];
  const int Rld = cluster_rld(R);
  short* Pt = reinterpret_cast<short*>(smem4);          // (64, Rld)
  unsigned char* piv = reinterpret_cast<unsigned char*>(Pt + kNB * Rld);
  // per step parity: this block's message, and every block's
  __shared__ Candidate s_out[2];
  __shared__ Candidate s_in[2][kCluster];
  __shared__ __align__(8) unsigned long long s_bar[2];
  __shared__ int s_loc[3], s_lr[kNB];  // s_loc rotates over 3 steps
  const spasm::Fp F(p);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int me = static_cast<int>(cluster.block_rank());
  const bool lead = me == 0;
  const int row0 = me * R;
  const int Rb = max(0, min(R, n - row0));
  if (lead) stamp<kStamp>(stamps, 0);
  for (int idx = tid; idx < Rb * kNB; idx += kThreads) {
    const int i = idx >> 6;
    const int c = idx & (kNB - 1);
    Pt[c * Rld + i] = static_cast<short>(
        P[static_cast<long long>(row0 + i) * ld + c]);
  }
  for (int i = tid; i < R; i += kThreads)
    piv[i] = i < Rb ? piv_in[row0 + i] : 1;
  if (tid < 3) s_loc[tid] = R;
  if (tid < 2) spasm::mbar_init(&s_bar[tid]);
  // S = min(8, 1024 / Rb) threads per row: thread tid < S * rstep
  // (rstep = 1024 / S) serves rows tid / S + k * rstep; its lane s = tid %
  // S scans (s == 0) and updates columns t + 1 + s, t + 1 + s + S, ... —
  // so the column that the next step scans is written by the thread that
  // scans it.  (Sending the next candidate before the bulk of the update,
  // to overlap the exchange with it, cost more barriers than it hid.)
  const int S = Rb > 0 ? max(1, min(8, kThreads / Rb)) : 8;
  const int rstep = kThreads / S;
  const int sl = tid % S;
  const int rfirst = tid < S * rstep ? tid / S : Rb;
  cluster.sync();                       // every block's mbarriers are set
  if (lead) stamp<kStamp>(stamps, 1);
  for (int t = 0; t < kNB; ++t) {
    const int b = t & 1;
    const int sb = t % 3;
    // s_loc[(t + 1) % 3] was last read at step t - 2, before the last
    // block barrier; the next one orders this reset before its use
    if (tid == 0) s_loc[sb == 2 ? 0 : sb + 1] = R;
    int lmin = R;
    if (sl == 0)
      for (int i = rfirst; i < Rb; i += rstep)
        if (!piv[i] && Pt[t * Rld + i] != 0) {
          lmin = i;
          break;
        }
    lmin = __reduce_min_sync(0xffffffffu, lmin);
    if (lane == 0 && lmin < R) atomicMin(&s_loc[sb], lmin);
    __syncthreads();
    if (tid < kNB) {                    // the message: warps 0 and 1
      const int l = s_loc[sb];
      s_out[b].val[tid] = l < R ? Pt[tid * Rld + l] : 0;
      if (tid == 0) s_out[b].row = l < R ? row0 + l : n;
      spasm::send_to_all<kCluster>(&s_out[b], &s_in[b][me], &s_bar[b]);
    }
    spasm::mbar_wait(spasm::smem_addr(&s_bar[b]), (t >> 1) & 1);
    int r = lane < kCluster ? s_in[b][lane].row : n;
    r = __reduce_min_sync(0xffffffffu, r);
    if (tid == 0) s_lr[t] = r < n ? r : -1;
    if (r >= n) continue;               // cluster-uniform: empty slot
    const short* prow = s_in[b][r / R].val;
    const int v = prow[t];
    for (int i = rfirst; i < Rb; i += rstep) {
      if (row0 + i == r) {              // the pivot row
        if (sl == 0) piv[i] = 1;
        continue;
      }
      if (piv[i]) continue;
      const int g = Pt[t * Rld + i];
      if (g == 0) continue;
      for (int c = t + 1 + sl; c < kNB; c += S) {
        short* e = &Pt[c * Rld + i];
        *e = static_cast<short>(F.red(v * *e - g * prow[c]));
      }
    }
    // s_in[b] is written again (step t + 2) only after every block has
    // passed step t + 1's exchange, which needs this block's message of
    // step t + 1, sent after its next block barrier; by then this block's
    // copies of step t, and so their reads of s_out[b], are complete
  }
  __syncthreads();
  for (int i = tid; i < Rb; i += kThreads) piv_out[row0 + i] = piv[i];
  spasm::sends_done<kCluster>();
  if (!lead) return;
  __syncthreads();
  stamp<kStamp>(stamps, 2);
  // the panel is dead: the minor takes its shared memory
  minor<kStamp>(P, ld, s_lr, lrows, lhas, Z, Vinv,
                *reinterpret_cast<MinorShared*>(smem4), F, rref != 0,
                stamps);
}

// ---- cooperative variant ---------------------------------------------

template <bool kStamp>
__global__ void __launch_bounds__(kThreads)
panel_coop(const int* __restrict__ P, long long ld, int n,
           const unsigned char* __restrict__ piv_in, int* lrows,
           unsigned char* lhas, unsigned char* piv, int* Z, int* Vinv,
           int* Pt, int* rslot, int p, int rref, long long* stamps) {
  cg::grid_group grid = cg::this_grid();
  const spasm::Fp F(p);
  const int tid = threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + tid;
  const long long nn = n;
  const bool lead = blockIdx.x == 0;
  __shared__ int s_min;
  __shared__ int s_prow[kNB];
  __shared__ int s_lr[kNB];
  __shared__ MinorShared ms;
  if (lead) stamp<kStamp>(stamps, 0);
  // the working copy, transposed (64, n) in device memory (L2)
  for (long long i = first; i < nn; i += stride) {
    piv[i] = piv_in[i];
    for (int c = 0; c < kNB; ++c) Pt[c * nn + i] = P[i * ld + c];
  }
  if (lead && tid < kNB) rslot[tid] = n;   // n: no pivot
  grid.sync();
  if (lead) stamp<kStamp>(stamps, 1);
  for (int t = 0; t < kNB; ++t) {
    if (tid == 0) s_min = n;
    __syncthreads();
    int lmin = n;                       // rows ascend: the first hit is min
    for (long long i = first; i < nn; i += stride)
      if (!piv[i] && Pt[t * nn + i] != 0) {
        lmin = static_cast<int>(i);
        break;
      }
    lmin = __reduce_min_sync(0xffffffffu, lmin);
    if ((tid & 31) == 0 && lmin < n) atomicMin(&s_min, lmin);
    __syncthreads();
    if (tid == 0 && s_min < n) atomicMin(&rslot[t], s_min);
    grid.sync();
    const int r = __ldcg(&rslot[t]);
    if (r >= n) continue;               // grid-uniform: empty slot
    if (tid < kNB) s_prow[tid] = __ldcg(&Pt[tid * nn + r]);
    __syncthreads();
    const int v = s_prow[t];
    for (long long i = first; i < nn; i += stride) {
      if (i == r) {
        piv[i] = 1;
        continue;
      }
      if (piv[i]) continue;
      const int g = Pt[t * nn + i];
      if (g == 0) continue;
      for (int c = t + 1; c < kNB; ++c) {
        int* e = &Pt[c * nn + i];
        *e = F.red(v * *e - g * s_prow[c]);
      }
    }
    // s_prow is rewritten only after the next grid.sync
  }
  if (!lead) return;
  stamp<kStamp>(stamps, 2);
  if (tid < kNB) {
    const int r = __ldcg(&rslot[tid]);
    s_lr[tid] = r < n ? r : -1;
  }
  __syncthreads();
  minor<kStamp>(P, ld, s_lr, lrows, lhas, Z, Vinv, ms, F, rref != 0, stamps);
}

template <bool kStamp>
cudaError_t launch_cluster(const int* P, long long ld, int n,
                           const unsigned char* piv_in, int* lrows,
                           unsigned char* lhas, unsigned char* piv_out,
                           int* Z, int* Vinv, int p, int rref,
                           long long* stamps, cudaStream_t s) {
  static bool ready[spasm::kMaxDevices] = {};  // attributes set, per card
  int dev = 0;
  cudaError_t e = spasm::current_device(&dev);
  if (e != cudaSuccess) return e;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(panel_cluster<kStamp>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(panel_cluster<kStamp>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cluster_smem(kRowsMax)));
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  const int R = (n + kCluster - 1) / kCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = cluster_smem(R);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, panel_cluster<kStamp>, P, ld, n, R, piv_in,
                            lrows, lhas, piv_out, Z, Vinv, p, rref, stamps);
}

template <bool kStamp>
cudaError_t launch_coop(const int* P, long long ld, int n,
                        const unsigned char* piv_in, int* lrows,
                        unsigned char* lhas, unsigned char* piv_out, int* Z,
                        int* Vinv, int* Pt, int* rslot, int p, int rref,
                        long long* stamps, cudaStream_t s) {
  static int max_blocks[spasm::kMaxDevices] = {};  // co-resident, per card
  int dev = 0;
  cudaError_t e = spasm::current_device(&dev);
  if (e != cudaSuccess) return e;
  if (max_blocks[dev] == 0) {
    int sms = 0, per = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, panel_coop<kStamp>, kThreads, 0);
    if (e != cudaSuccess) return e;
    max_blocks[dev] = per * sms;
  }
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > max_blocks[dev]) blocks = max_blocks[dev];
  if (blocks < 1) blocks = 1;
  void* args[] = {&P,    &ld,   &n,  &piv_in, &lrows, &lhas,  &piv_out, &Z,
                  &Vinv, &Pt,   &rslot, &p,   &rref,  &stamps};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(panel_coop<kStamp>), dim3(blocks),
      dim3(kThreads), args, 0, s);
}

template <bool kStamp>
int panel(const void* P, long long ld, int n, const void* piv_in,
          void* lrows, void* lhas, void* piv_out, void* Z, void* Vinv,
          void* Pt, void* rslot, int p, int rref, int variant,
          long long* stamps, void* stream) {
  if (variant == 0 && n > kCluster * kRowsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* a_P = static_cast<const int*>(P);
  const unsigned char* a_in = static_cast<const unsigned char*>(piv_in);
  int* a_lrows = static_cast<int*>(lrows);
  unsigned char* a_lhas = static_cast<unsigned char*>(lhas);
  unsigned char* a_out = static_cast<unsigned char*>(piv_out);
  int* a_Z = static_cast<int*>(Z);
  int* a_Vinv = static_cast<int*>(Vinv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      variant == 0
          ? launch_cluster<kStamp>(a_P, ld, n, a_in, a_lrows, a_lhas, a_out,
                                   a_Z, a_Vinv, p, rref, stamps, s)
          : launch_coop<kStamp>(a_P, ld, n, a_in, a_lrows, a_lhas, a_out,
                                a_Z, a_Vinv, static_cast<int*>(Pt),
                                static_cast<int*>(rslot), p, rref, stamps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P: (n, 64) int32 panel at row stride ld (elements); piv_in / piv_out
// (n,) bool; lrows (64,) int32, lhas (64,) bool, Z and Vinv (64, 64)
// int32 (Vinv unused when rref).  variant: 0 = cluster (n <= 24576),
// 1 = cooperative (any n), which also takes Pt (64 * n,) and rslot (64,)
// int32 scratch (unused by the cluster variant).  One launch either way.
extern "C" int spasm_panel(const void* P, long long ld, int n,
                           const void* piv_in, void* lrows, void* lhas,
                           void* piv_out, void* Z, void* Vinv, void* Pt,
                           void* rslot, int p, int rref, int variant,
                           void* stream) {
  return panel<false>(P, ld, n, piv_in, lrows, lhas, piv_out, Z, Vinv, Pt,
                      rslot, p, rref, variant, nullptr, stream);
}

// The same with phase stamps: stamps (12,) int64 receives clock64() of
// block 0 at the six phase borders, then %globaltimer (ns) at the same.
extern "C" int spasm_panel_stamped(const void* P, long long ld, int n,
                                   const void* piv_in, void* lrows,
                                   void* lhas, void* piv_out, void* Z,
                                   void* Vinv, void* Pt, void* rslot, int p,
                                   int rref, int variant, void* stamps,
                                   void* stream) {
  return panel<true>(P, ld, n, piv_in, lrows, lhas, piv_out, Z, Vinv, Pt,
                     rslot, p, rref, variant, static_cast<long long*>(stamps),
                     stream);
}

// Most rows the cluster variant takes.
extern "C" int spasm_panel_cluster_rows() { return kCluster * kRowsMax; }
