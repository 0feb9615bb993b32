// B2 and B3: the row sweeps of the row-sweep RREF, for Hopper (sm_90a).
//
// Both run the division-free Jordan steps of one (nb, M) int32 sub-panel
// P (nb = 64 rows, the whole finisher width M in columns), in place, and
// return each row's pivot column or -1.  Step k: j = pivot column of row
// k, v = P[k, j], g = P[:, j] with g[k] = 0, then P <- v * P - g (x) P[k]
// reduced mod p (|.| <= 2 (p/2)^2 < 2^31 for p <= 65279).
//
// B2 replaces `_row_sweep_kernel` (spasm_tpu/dense/rowrref.py:55,
// pallas_call at :286): j is the leftmost nonzero of row k over the whole
// width.  On the TPU the panel sat in VMEM.  Two variants, chosen by
// (nb, M) alone (dense/rowrref.py `row_sweep_variant`):
//   * `spasm_row_sweep_cluster` (nb <= 64, M <= kCB * kCColsMax = 8192;
//     the main path's M = 2048): ONE launch per sweep.  A cluster of kCB
//     = 8 blocks holds the panel in shared memory as int16 (p <= 65279
//     keeps every balanced residue in int16), each block a slice of W =
//     M / 8 columns (256 at M = 2048), two columns per 32-bit word.  Step
//     k: each block has the leftmost nonzero of row k in its slice (found
//     while step k - 1 updated that row), and sends one candidate -- the column, or
//     none, and that column's 64 values -- to every block of the cluster
//     (the 144-byte message and TMA exchange of cluster.cuh, as in B4);
//     every block takes the smallest column, which gives it j, v and g
//     without a second exchange, and applies P <- v P - g (x) P[k] to its
//     own slice.  One exchange and one block barrier per step; a
//     cluster.sync() at the start and at the end, so no block exits while
//     another may still copy into it.  Eight blocks rather than four:
//     the update (64 x W elements a step, ~30 instructions a word pair) is
//     bound by one SM's issue rate, so eight halve it, and eight is the
//     largest portable cluster.  Bound: the 64 dependent steps (an
//     exchange is ~1.8 us, B4's measurement) plus each step's slice
//     update, not the panel's bytes (0.5 MB at M = 2048).
//   * the pair `sweep_find` + `sweep_update` (any nb <= 1024 and M, for
//     shapes beyond the cluster): 5.8 MB at M = 22528 is far above a
//     block's 227 KB, so the columns spread over the grid and each step
//     is two launches: a one-block find of j (plus the gather of the
//     pivot column g), then a column-parallel update in which each thread
//     owns one column for all rows (it reads P[k, c] before writing any
//     row, so row k's own update cannot race).  The panel stays in the 50
//     MB L2 between steps; the bound is the 2 x nb launches per sweep.
//
// B3 `spasm_row_sweep_tiles` replaces `_row_sweep_kernel2`
// (rowrref.py:126, pallas_call at :302): the tile rule.  Tiles of kTW =
// 512 columns are visited left to right; a tile where some row not yet
// pivoted has a nonzero is live, and there each such row, in order, takes
// the leftmost nonzero inside the tile as its pivot.  The TPU kernel, and
// this port's first version, swept [tile | I_64] per tile and composed the
// tile's transform into every other tile: 2 M / kTW launches per sweep and
// T 64 64 M multiply-adds for T live tiles.  Every step left-multiplies
// the panel by a 64 x 64 matrix, so the sweep's result is W P_in with W
// the product of the tiles' transforms, and every stored value is a
// balanced (canonical) residue, so any association of that product gives
// the same integers.  The redesign is left-looking, ONE cooperative launch
// (grid = co-resident blocks of 1024 threads, at most M / 64):
//   1. all blocks: the first column >= the next tile where a row not yet
//      pivoted of W P_in is nonzero (a grid-wide min; none, or every row
//      pivoted, ends the loop);
//   2. block 0: the pass over that tile, applying each Jordan step to W
//      alone (64 x 64 in shared memory; the tile itself is only read);
//   3. repeat from the tile after it: 2 grid barriers per live tile;
//   4. all blocks: P <- W P_in, 64 64 M multiply-adds, each block on its
//      own column chunks, read whole before they are written.
// Bound: the sequential steps of the live passes, at most 64 per sweep,
// each a 64 x 64 update of W plus a 256-column scan on one SM (integer
// work bound by the SM's instruction rate, three cheap block barriers);
// then the grid barriers and the final product (92 M multiply-adds with
// int64 sums on CUDA cores); the bytes (the panel read and written once:
// 11.5 MB at M = 22528, 3.4 us) come last.  Products of balanced values
// are < 2^30, so sums of 64 are exact in int64 and reduced through FP64
// (spasm::Fp).  The pivots depend on kTW: dense/rowrref.py follows the
// same algorithm in torch (`_row_sweep_tiles_plain`) and the two are
// bit-equal.  The sweep adds its count of live tiles to a histogram on
// the card (hist).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"
#include "device.cuh"
#include "modp.cuh"

namespace cg = cooperative_groups;

namespace {

// ----------------------------------------------------------- B2 pair ----

constexpr int kFindThreads = 1024;
constexpr int kUpdThreads = 256;

// st: [0] = j (-1: row k is zero), [1] = v, [2 .. 2 + nb) = g
__global__ void __launch_bounds__(kFindThreads)
sweep_find(const int* __restrict__ P, int nb, int M, int k, int* st,
           int* pivcol) {
  __shared__ int s_j;
  if (threadIdx.x == 0) s_j = M;
  __syncthreads();
  const int* u = P + static_cast<int64_t>(k) * M;
  int jl = M;
  for (int c = threadIdx.x; c < M; c += blockDim.x)
    if (u[c] != 0) {
      jl = c;
      break;
    }
  jl = __reduce_min_sync(0xffffffffu, jl);
  if ((threadIdx.x & 31) == 0 && jl < M) atomicMin(&s_j, jl);
  __syncthreads();
  const int j = s_j;
  if (j == M) {
    if (threadIdx.x == 0) {
      st[0] = -1;
      pivcol[k] = -1;
    }
    return;
  }
  for (int i = threadIdx.x; i < nb; i += blockDim.x)
    st[2 + i] = (i == k) ? 0 : P[static_cast<int64_t>(i) * M + j];
  if (threadIdx.x == 0) {
    st[0] = j;
    st[1] = u[j];
    pivcol[k] = j;
  }
}

__global__ void __launch_bounds__(kUpdThreads)
sweep_update(int* __restrict__ P, int nb, int M, int k,
             const int* __restrict__ st, int p) {
  const int j = st[0];
  if (j < 0) return;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= M) return;
  const float invp = 1.0f / static_cast<float>(p);
  const int v = st[1];
  const int u = P[static_cast<int64_t>(k) * M + c];
  for (int i = 0; i < nb; ++i) {
    int* e = P + static_cast<int64_t>(i) * M + c;
    *e = spasm::reduce31(v * *e - st[2 + i] * u, p, invp);
  }
}

// ---------------------------------------------------------------- B3 ----

constexpr int kNB = 64;                 // sub-panel rows
constexpr int kTW = 512;                // tile width (the pivot rule's)
constexpr int kThreads = 1024;
constexpr int kWld = kNB + 1;           // W rows, padded
constexpr int kBld = kTW + 8;           // tile rows: the pad puts the four
                                        // partial sums of a column on
                                        // four bank groups
constexpr int kCW = 64;                 // columns per find / product chunk
constexpr int kCld = kCW + 1;
constexpr int kHalf = kTW / 2;          // columns per scan of a step
// W, the other W buffer of the pass, the tile
constexpr size_t kSmemBytes = sizeof(int) * (2 * kNB * kWld + kNB * kBld);
// state (int32): W[kNB * kNB], col[kNB] (pivot column or -1), then one
// `next` slot per live tile (and one for the search that ends the sweep)
constexpr int kStCol = kNB * kNB;
constexpr int kStNext = kStCol + kNB;
constexpr int kStSize = kStNext + kNB + 1;

struct SweepShared {
  int col[kNB];
  int unp[kNB];                         // rows not yet pivoted, ascending
  int nunp;
  int g[kNB];
  int row[kHalf];                       // a scanned half of row k
  int j[3];
  int min, lim;
  int cb0;                              // the tile's first nonzero column
};

// Every block: the pivot state and W from global memory (W = I, not read,
// until the first live tile), and the list of rows not yet pivoted.
__device__ void load_state(const int* st, int* sW, SweepShared& s,
                           bool ident) {
  const int tid = threadIdx.x;
  if (!ident)
    for (int idx = tid; idx < kNB * kNB; idx += kThreads)
      sW[(idx >> 6) * kWld + (idx & 63)] = __ldcg(st + idx);
  if (tid < kNB) s.col[tid] = __ldcg(st + kStCol + tid);
  if (tid == 0) s.cb0 = kTW;
  __syncthreads();
  if (tid < 32) {
    int base = 0;
    for (int h = 0; h < kNB; h += 32) {
      const bool u = s.col[h + tid] < 0;
      const unsigned m = __ballot_sync(0xffffffffu, u);
      if (u) s.unp[base + __popc(m & ((1u << tid) - 1u))] = h + tid;
      base += __popc(m);
    }
    if (tid == 0) s.nunp = base;
  }
  __syncthreads();
}

// Step 1, every block: the first column >= cstart where a row not yet
// pivoted of W P has a nonzero, atomicMin'd into *next.  Chunks of kCW
// columns go round-robin over the blocks, so the earliest chunks are
// scanned first; a block stops at its first hit, or once its chunk starts
// past the best column found so far.
__device__ void find_next(const int* __restrict__ P, int M, int cstart,
                          const int* sW, int* sC, SweepShared& s, bool ident,
                          int* next, const spasm::Fp& F) {
  const int tid = threadIdx.x;
  const int nout = s.nunp * kCW;
  for (int c0 = cstart + blockIdx.x * kCW; c0 < M; c0 += gridDim.x * kCW) {
    __syncthreads();                    // the last chunk's reads are done
    if (tid == 0) {
      s.min = M;
      s.lim = __ldcg(next);
    }
    if (!ident)
      for (int idx = tid; idx < kNB * kCW; idx += kThreads)
        sC[(idx >> 6) * kCld + (idx & 63)] =
            P[static_cast<int64_t>(idx >> 6) * M + c0 + (idx & 63)];
    __syncthreads();
    if (c0 >= s.lim) return;            // block-uniform
    int cand = M;
    for (int idx = tid; idx < nout; idx += kThreads) {
      const int i = s.unp[idx >> 6];
      const int c = idx & 63;
      int x;
      if (ident) {
        x = P[static_cast<int64_t>(i) * M + c0 + c];
      } else {
        const int* w = sW + i * kWld;
        long long acc = 0;
#pragma unroll 16
        for (int l = 0; l < kNB; ++l)
          acc += static_cast<long long>(w[l]) * sC[l * kCld + c];
        x = F.red64(acc);
      }
      if (x != 0 && c0 + c < cand) cand = c0 + c;
    }
    cand = __reduce_min_sync(0xffffffffu, cand);
    if ((tid & 31) == 0 && cand < M) atomicMin(&s.min, cand);
    __syncthreads();
    if (s.min < M) {                    // block-uniform
      if (tid == 0) atomicMin(next, s.min);
      return;
    }
  }
}

// Step 2, one block: the pass over tile [c0, c0 + kTW), left-looking.  The
// tile X = W B (B = P_in[:, tile]) is never formed: row k of the current
// tile is W[k] B, scanned kHalf columns at a time, from B's first nonzero
// column, for its leftmost nonzero j (four threads per column); the pivot
// column is W B[:, j] (four threads per row); and the Jordan step X <- v
// X - g (x) X[k] is applied to W alone, so W ends as Z_t W.  Every value
// is the balanced residue the right-looking sweep holds at that point, so
// the pivots are the same.  W is double-buffered: a step reads one buffer
// (its row k is the step's X[k] factor) and writes the other, at the start
// of the next visit; three cheap block barriers per step.  Returns the
// buffer holding the final W.
__device__ const int* tile_pass(const int* __restrict__ P, int M, int c0,
                                int* sW, int* sW2, int* sB, SweepShared& s,
                                bool ident, const spasm::Fp& F) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  constexpr int kQ = kTW / 4;           // int4 per tile row
  int nz0 = kTW;                        // columns left of it are zero in B
  for (int idx = tid; idx < kNB * kQ; idx += kThreads) {
    const int l = idx / kQ;
    const int c4 = idx - l * kQ;
    const int4 x = reinterpret_cast<const int4*>(
        P + static_cast<int64_t>(l) * M + c0)[c4];
    reinterpret_cast<int4*>(sB + l * kBld)[c4] = x;
    if ((x.x | x.y | x.z | x.w) != 0 && 4 * c4 < nz0) nz0 = 4 * c4;
  }
  nz0 = __reduce_min_sync(0xffffffffu, nz0);
  if (lane == 0 && nz0 < kTW) atomicMin(&s.cb0, nz0);
  if (ident)
    for (int idx = tid; idx < kNB * kNB; idx += kThreads)
      sW[(idx >> 6) * kWld + (idx & 63)] = (idx >> 6) == (idx & 63);
  if (tid == 0) s.j[0] = kTW;
  __syncthreads();
  const int cb0 = s.cb0;                // the scan starts there
  int* cur = sW;
  int* nxt = sW2;
  // a step not yet applied to W: v, s.g and row kp of cur
  int v = 0, kp = -1;
  int jb = 0;                           // s.j rotates over 3 visits
  auto apply = [&]() {
    const int* wk = cur + kp * kWld;
    for (int idx = tid; idx < kNB * kNB; idx += kThreads) {
      const int i = idx >> 6, l = idx & 63;
      nxt[i * kWld + l] = F.red(v * cur[i * kWld + l] - s.g[i] * wk[l]);
    }
    int* t = cur;
    cur = nxt;
    nxt = t;
    kp = -1;
  };
  for (int k = 0; k < kNB; ++k) {
    if (s.col[k] >= 0) continue;        // block-uniform
    int* sj = &s.j[jb];
    jb = jb == 2 ? 0 : jb + 1;
    if (tid == 0) s.j[jb] = kTW;        // the next visit's slot
    if (kp >= 0) {
      apply();
      __syncthreads();
    }
    const int* wk = cur + k * kWld;
    int j = kTW, h0 = cb0;
    for (; h0 < kTW; h0 += kHalf) {
      const int cc = tid >> 2, q = tid & 3;
      const int* b = sB + h0 + cc;
      long long acc = 0;
      if (h0 + cc < kTW) {
#pragma unroll
        for (int m = 0; m < kNB / 4; ++m) {
          const int l = 4 * m + q;
          acc += static_cast<long long>(wk[l]) * b[l * kBld];
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      int cand = kTW;
      if (q == 0) {
        const int x = F.red64(acc);
        s.row[cc] = x;
        if (x != 0) cand = h0 + cc;
      }
      cand = __reduce_min_sync(0xffffffffu, cand);
      if (lane == 0 && cand < kTW) atomicMin(sj, cand);
      __syncthreads();
      j = *sj;
      if (j < kTW) break;               // block-uniform
    }
    if (j == kTW) continue;             // row k is zero on this tile
    const int vk = s.row[j - h0];
    if (tid < 4 * kNB) {                // the pivot column, 4 per row
      const int i = tid >> 2, q = tid & 3;
      const int* w = cur + i * kWld;
      long long acc = 0;
#pragma unroll
      for (int m = 0; m < kNB / 4; ++m) {
        const int l = 4 * m + q;
        acc += static_cast<long long>(w[l]) * sB[l * kBld + j];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0) s.g[i] = i == k ? 0 : F.red64(acc);
    }
    if (tid == 0) s.col[k] = c0 + j;
    __syncthreads();
    v = vk;
    kp = k;
  }
  if (kp >= 0) {
    apply();
    __syncthreads();
  }
  return cur;
}

// Step 4, every block: P <- W P_in over its round-robin chunks of kCW
// columns, each read whole into shared memory before it is written.
__device__ void apply_w(int* __restrict__ P, int M, const int* sW, int* sC,
                        const spasm::Fp& F) {
  const int tid = threadIdx.x;
  const int r0 = tid >> 6, c = tid & 63;    // rows r0 + 16 m, one column
  for (int c0 = blockIdx.x * kCW; c0 < M; c0 += gridDim.x * kCW) {
    __syncthreads();
    for (int idx = tid; idx < kNB * kCW; idx += kThreads)
      sC[(idx >> 6) * kCld + (idx & 63)] =
          P[static_cast<int64_t>(idx >> 6) * M + c0 + (idx & 63)];
    __syncthreads();
    long long acc[4] = {0, 0, 0, 0};
#pragma unroll 8
    for (int l = 0; l < kNB; ++l) {
      const long long b = sC[l * kCld + c];
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] += sW[(r0 + 16 * m) * kWld + l] * b;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
      P[static_cast<int64_t>(r0 + 16 * m) * M + c0 + c] = F.red64(acc[m]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tile_sweep(int* __restrict__ P, int M, int* st, int* hist, int p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int4 smem4[];
  int* sW = reinterpret_cast<int*>(smem4);
  int* sW2 = sW + kNB * kWld;
  int* sB = sW2 + kNB * kWld;           // the pass's tile, or a chunk
  __shared__ SweepShared s;
  const spasm::Fp F(p);
  const int tid = threadIdx.x;
  if (blockIdx.x == 0) {
    if (tid < kNB) st[kStCol + tid] = -1;
    if (tid <= kNB) st[kStNext + tid] = M;
  }
  grid.sync();
  bool ident = true;                    // W = I until the first live tile
  int live = 0, cstart = 0;
  for (;;) {
    load_state(st, sW, s, ident);
    if (s.nunp == 0 || cstart >= M) break;        // grid-uniform
    find_next(P, M, cstart, sW, sB, s, ident, st + kStNext + live, F);
    grid.sync();
    const int nx = __ldcg(st + kStNext + live);
    if (nx >= M) break;                           // grid-uniform
    const int c0 = nx / kTW * kTW;
    if (blockIdx.x == 0) {
      const int* W = tile_pass(P, M, c0, sW, sW2, sB, s, ident, F);
      for (int idx = tid; idx < kNB * kNB; idx += kThreads)
        st[idx] = W[(idx >> 6) * kWld + (idx & 63)];
      if (tid < kNB) st[kStCol + tid] = s.col[tid];
    }
    grid.sync();
    ident = false;
    ++live;
    cstart = c0 + kTW;
  }
  if (!ident) apply_w(P, M, sW, sB, F);
  if (blockIdx.x == 0 && tid == 0) atomicAdd(hist + live, 1);
}

// -------------------------------------------------------- B2 cluster ----

constexpr int kCB = 8;                  // blocks per cluster
constexpr int kCColsMax = 1024;         // columns per block
constexpr int kCThreads = 1024;
constexpr int kPairT = 128;             // threads per row group
constexpr int kGroups = kCThreads / kPairT;

// A step's message: the block's leftmost nonzero column of row k (M:
// none) and that column's 64 values.
struct __align__(16) ColCandidate {
  int col;
  int pad[3];
  short val[kNB];
};

// Columns per block, even (two int16 columns per 32-bit word).
__host__ __device__ inline int cluster_width(int M) {
  return ((M + kCB - 1) / kCB + 1) & ~1;
}

__host__ __device__ inline size_t cluster_sweep_smem(int M) {
  return sizeof(int) * (kNB + 2) * (cluster_width(M) / 2);
}

__device__ __forceinline__ int lo16(int w) { return static_cast<short>(w); }
__device__ __forceinline__ int hi16(int w) { return w >> 16; }
__device__ __forceinline__ int pack16(int lo, int hi) {
  return static_cast<int>((static_cast<unsigned>(lo) & 0xffffu) |
                          (static_cast<unsigned>(hi) << 16));
}

// Row k of the slice: its words into su (the step's snapshot), and this
// block's leftmost nonzero column in it atomicMin'd into *loc.
__device__ __forceinline__ void scan_row(const int* S, int npairs, int k,
                                         int* su, int* loc, int W) {
  int jl = W;
  for (int q = threadIdx.x; q < npairs; q += kCThreads) {
    const int w = S[k * npairs + q];
    su[q] = w;
    if (w != 0 && jl == W) jl = lo16(w) != 0 ? 2 * q : 2 * q + 1;
  }
  jl = __reduce_min_sync(0xffffffffu, jl);
  if ((threadIdx.x & 31) == 0 && jl < W) atomicMin(loc, jl);
}

__global__ void __launch_bounds__(kCThreads, 1)
sweep_cluster(int* __restrict__ P, int nb, int M, int* __restrict__ pivcol,
              int p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int4 smem4[];
  const int W = cluster_width(M);
  const int npairs = W / 2;
  int* S = reinterpret_cast<int*>(smem4);       // (64, npairs) words
  int* s_u = S + kNB * npairs;                  // [2][npairs]: row k, k + 1
  // per step parity: this block's message, and every block's
  __shared__ ColCandidate s_out[2];
  __shared__ ColCandidate s_in[2][kCB];
  __shared__ __align__(8) unsigned long long s_bar[2];
  __shared__ int s_loc[3], s_piv[kNB];          // s_loc rotates over 3 steps
  const spasm::Fp F(p);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int me = static_cast<int>(cluster.block_rank());
  const int c0 = me * W;
  const int Wb = max(0, min(W, M - c0));        // this block's columns
  for (int idx = tid; idx < kNB * npairs; idx += kCThreads) {
    const int i = idx / npairs;
    const int c = 2 * (idx - i * npairs);
    const int* src = P + static_cast<int64_t>(i) * M + c0 + c;
    const int lo = i < nb && c < Wb ? src[0] : 0;
    const int hi = i < nb && c + 1 < Wb ? src[1] : 0;
    S[idx] = pack16(lo, hi);
  }
  if (tid < 3) s_loc[tid] = W;
  if (tid < 2) spasm::mbar_init(&s_bar[tid]);
  __syncthreads();
  scan_row(S, npairs, 0, s_u, &s_loc[0], W);
  cluster.sync();                       // every block's mbarriers are set
  // the update: thread tid serves rows rg, rg + 8, ... at words qt,
  // qt + 128, ... (a warp on 32 consecutive words of one row)
  const int rg = tid / kPairT;
  const int qt = tid % kPairT;
  // Step k starts with row k's snapshot in s_u[k & 1] and the block's
  // candidate in s_loc[k % 3]; the update of row k + 1 writes that row's
  // snapshot and candidate for step k + 1 (a plain scan after a step
  // without pivot), so a step has one exchange and one block barrier.
  for (int k = 0; k < nb; ++k) {
    const int b = k & 1;
    const int sb = k % 3;
    const int sn = sb == 2 ? 0 : sb + 1;
    // s_loc[(k + 2) % 3] was last read at step k - 1, before the last
    // block barrier; it takes its atomicMins at step k + 1
    if (tid == 0) s_loc[sn == 2 ? 0 : sn + 1] = W;
    const int* su = s_u + b * npairs;
    int* sun = s_u + (b ^ 1) * npairs;
    if (tid < kNB) {                    // the message: warps 0 and 1
      const int l = s_loc[sb];
      int x = 0;
      if (l < W) {
        const int w = S[tid * npairs + (l >> 1)];
        x = (l & 1) ? hi16(w) : lo16(w);
      }
      s_out[b].val[tid] = static_cast<short>(x);
      if (tid == 0) s_out[b].col = l < W ? c0 + l : M;
      spasm::send_to_all<kCB>(&s_out[b], &s_in[b][me], &s_bar[b]);
    }
    spasm::mbar_wait(spasm::smem_addr(&s_bar[b]), (k >> 1) & 1);
    int j = lane < kCB ? s_in[b][lane].col : M;
    j = __reduce_min_sync(0xffffffffu, j);
    if (tid == 0) s_piv[k] = j < M ? j : -1;
    if (j >= M) {                       // cluster-uniform: row k is zero
      if (k + 1 < nb) scan_row(S, npairs, k + 1, sun, &s_loc[sn], W);
      __syncthreads();
      continue;
    }
    const short* gcol = s_in[b][j / W].val;
    const int v = gcol[k];
    int jl = W;                         // row k + 1's leftmost, this thread
    for (int i = rg; i < nb; i += kGroups) {
      const int g = i == k ? 0 : gcol[i];
      int* row = S + i * npairs;
      for (int q = qt; q < npairs; q += kPairT) {
        const int w = row[q];
        const int u = su[q];
        const int x = pack16(F.red(v * lo16(w) - g * lo16(u)),
                             F.red(v * hi16(w) - g * hi16(u)));
        row[q] = x;
        if (i == k + 1) {
          sun[q] = x;
          if (x != 0 && jl == W) jl = lo16(x) != 0 ? 2 * q : 2 * q + 1;
        }
      }
    }
    jl = __reduce_min_sync(0xffffffffu, jl);
    if (lane == 0 && jl < W) atomicMin(&s_loc[sn], jl);
    __syncthreads();                    // the slice, s_u and s_loc, for k + 1
    // s_in[b] is written again (step k + 2) only after every block has
    // passed step k + 1's exchange, which needs this block's message of
    // step k + 1, sent after this barrier; by then this block's copies of
    // step k, and so their reads of s_out[b], are complete
  }
  for (int idx = tid; idx < nb * npairs; idx += kCThreads) {
    const int i = idx / npairs;
    const int c = 2 * (idx - i * npairs);
    int* dst = P + static_cast<int64_t>(i) * M + c0 + c;
    if (c < Wb) dst[0] = lo16(S[idx]);
    if (c + 1 < Wb) dst[1] = hi16(S[idx]);
  }
  if (me == 0 && tid < nb) pivcol[tid] = s_piv[tid];
  spasm::sends_done<kCB>();
  cluster.sync();                       // no copy still targets this block
}

}  // namespace

// B2, the pair: P (nb, M) int32 in place, nb <= 1024; pivcol (nb,) int32;
// st (2 + nb,) int32 scratch.  2 * nb launches.
extern "C" int spasm_row_sweep(void* P, int nb, int M, void* pivcol,
                               void* st, int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* Pi = static_cast<int*>(P);
  int* sti = static_cast<int*>(st);
  const int ublocks = (M + kUpdThreads - 1) / kUpdThreads;
  for (int k = 0; k < nb; ++k) {
    sweep_find<<<1, kFindThreads, 0, s>>>(Pi, nb, M, k, sti,
                                          static_cast<int*>(pivcol));
    sweep_update<<<ublocks, kUpdThreads, 0, s>>>(Pi, nb, M, k, sti, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// P (64, M) int32 in place, M % 512 == 0, 16-byte aligned; st (kStSize,)
// int32 scratch, whose col part [4096, 4160) is the pivot column per row
// (-1: none) on return; hist (65,) int32: hist[live tiles] += 1.  One
// cooperative launch.
extern "C" int spasm_row_sweep_tiles(void* P, int M, void* st, void* hist,
                                     int p, void* stream) {
  // co-resident blocks, per card (the attribute is set per card too)
  static int max_blocks[spasm::kMaxDevices] = {};
  int dev = 0;
  {
    const cudaError_t e = spasm::current_device(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (max_blocks[dev] == 0) {
    int sms = 0, per = 0;
    cudaError_t e = cudaFuncSetAttribute(
        tile_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, tile_sweep,
                                                        kThreads, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    max_blocks[dev] = per * sms;
  }
  int blocks = M / kCW;
  if (blocks > max_blocks[dev]) blocks = max_blocks[dev];
  int* a_P = static_cast<int*>(P);
  int* a_st = static_cast<int*>(st);
  int* a_hist = static_cast<int*>(hist);
  void* args[] = {&a_P, &M, &a_st, &a_hist, &p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(tile_sweep), dim3(blocks), dim3(kThreads), args,
      kSmemBytes, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spasm_tile_state_size() { return kStSize; }

extern "C" int spasm_tile_width() { return kTW; }

// B2, the cluster: P (nb, M) int32 in place, balanced, 1 <= nb <= 64,
// 1 <= M <= spasm_row_sweep_cluster_cols(); pivcol (nb,) int32.  One
// launch (a cluster of kCB blocks).
extern "C" int spasm_row_sweep_cluster(void* P, int nb, int M, void* pivcol,
                                       int p, void* stream) {
  if (nb < 1 || nb > kNB || M < 1 || M > kCB * kCColsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[spasm::kMaxDevices] = {};  // attribute set, per card
  int dev = 0;
  {
    const cudaError_t e = spasm::current_device(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (!ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cluster_sweep_smem(kCB * kCColsMax)));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCB);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = cluster_sweep_smem(M);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, sweep_cluster, static_cast<int*>(P), nb, M,
                         static_cast<int*>(pivcol), p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Most columns the cluster variant takes.
extern "C" int spasm_row_sweep_cluster_cols() { return kCB * kCColsMax; }
