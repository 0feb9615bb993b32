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
//   5. LU: Vinv, the inverse of the unit-upper D^-1 Omega, by 64 backward
//      row steps.
// Outputs lrows, lhas, is_piv', Z (and Vinv) are unique, so they equal
// the plain torch version (dense/panel.py) bit for bit.
//
// Bound on this card: 64 + 64 (+ 64) dependent steps, not bytes — the
// byte bound at (64, 4608) is 1.18 MB / 3.35 TB/s ~ 0.35 us.  Design: ONE
// cooperative launch (cudaLaunchCooperativeKernel) over at most
// ceil(n / 256) blocks of 256 threads, a thread per row (grid-stride
// beyond).  The working copy of the panel is scratch: transposed
// (64, n) in device memory so a step's column reads are coalesced; at
// n = 4608 it is 1.18 MB and stays in L2 (and each SM's share in L1).
// Step t: each thread checks its rows, a warp min + shared atomicMin +
// global atomicMin per block give the first available row, one
// grid.sync(), then every thread reads the pivot row from L2 (__ldcg:
// another SM wrote it) and updates its own available rows with a
// nonzero in column t, columns > t only.  Rows already pivotal and rows
// with a zero there are skipped (the TPU scaled them by v for nothing:
// only zero patterns of non-pivotal rows matter).  One grid.sync per
// step, since a row is written only by its owner and read by others only
// after it became the pivot.  Block 0 then runs phases 2-5 alone in
// 33 KB of shared memory: the 64 x 128 [W | I] with 256 threads.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "modp.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNB = 64;
constexpr int kThreads = 256;
constexpr int kW = 2 * kNB;             // [W | I]
constexpr int kLd = kW + 1;             // padded: column reads hit all banks

__global__ void __launch_bounds__(kThreads)
panel_kernel(const int* __restrict__ P, long long ld, int n,
             const unsigned char* __restrict__ piv_in, int* lrows,
             unsigned char* lhas, unsigned char* piv, int* Z, int* Vinv,
             int* Pt, int* rslot, int p, int rref) {
  cg::grid_group grid = cg::this_grid();
  const float invp = 1.0f / static_cast<float>(p);
  const int tid = threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const long long nn = n;
  __shared__ int s_min;
  __shared__ int s_prow[kNB];

  // ---- phase 1: discovery sweep over the working copy -----------------
  for (long long i = first; i < nn; i += stride) {
    piv[i] = piv_in[i];
    for (int c = 0; c < kNB; ++c) Pt[c * nn + i] = P[i * ld + c];
  }
  if (blockIdx.x == 0 && tid < kNB) rslot[tid] = n;   // n: no pivot
  grid.sync();
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
        *e = spasm::reduce31(v * *e - g * s_prow[c], p, invp);
      }
    }
    // s_prow is rewritten only after the next grid.sync
  }
  if (blockIdx.x != 0) return;

  // ---- phases 2-5: the 64 x 64 pivot minor, block 0 alone -------------
  __shared__ int M[kNB * kLd];
  __shared__ int s_lr[kNB], s_g[kNB], s_d[kNB], s_pr[kW];
  if (tid < kNB) {
    const int r = __ldcg(&rslot[tid]);
    s_lr[tid] = r < n ? r : -1;
    lrows[tid] = s_lr[tid];
    lhas[tid] = r < n ? 1 : 0;
  }
  __syncthreads();
  for (int idx = tid; idx < kNB * kW; idx += kThreads) {
    const int i = idx / kW;
    const int c = idx - i * kW;
    int x;
    if (c < kNB)
      x = (s_lr[i] >= 0 && s_lr[c] >= 0)
              ? P[static_cast<long long>(s_lr[i]) * ld + c]
              : (i == c);
    else
      x = (c - kNB == i);
    M[i * kLd + c] = x;
  }
  __syncthreads();
  for (int t = 0; t < kNB; ++t) {
    for (int c = tid; c < kW; c += kThreads) s_pr[c] = M[t * kLd + c];
    if (tid < kNB) {
      int g = M[tid * kLd + t];
      if (rref) {
        if (tid == t) g = spasm::reduce31(g - 1, p, invp);
      } else if (tid <= t) {
        g = 0;
      }
      s_g[tid] = g;
    }
    __syncthreads();
    const int v = s_pr[t];
    for (int idx = tid; idx < kNB * kW; idx += kThreads) {
      const int i = idx / kW;
      const int c = idx - i * kW;
      if (!rref && i <= t) continue;
      int* e = &M[i * kLd + c];
      *e = spasm::reduce31(v * *e - s_g[i] * s_pr[c], p, invp);
    }
    __syncthreads();
  }
  if (tid < kNB) s_d[tid] = spasm::modinv32(M[tid * kLd + tid], p, invp);
  __syncthreads();
  for (int idx = tid; idx < kNB * kNB; idx += kThreads) {
    const int i = idx / kNB;
    const int j = idx - i * kNB;
    Z[idx] = spasm::reduce31(s_d[i] * M[i * kLd + kNB + j], p, invp);
    // LU: the left half becomes Vup = D^-1 Omega (unit upper)
    if (!rref) M[i * kLd + j] = spasm::reduce31(s_d[i] * M[i * kLd + j], p,
                                                invp);
  }
  if (rref) return;
  __syncthreads();
  // Vinv into the right half (Z is out): row i = e_i - sum_{k>i} V[i,k]
  // Vinv[k], rows from the bottom; each sum <= 64 * p/2 fits an int
  for (int i = kNB - 1; i >= 0; --i) {
    if (tid < kNB) {
      int acc = 0;
      for (int k = i + 1; k < kNB; ++k)
        acc += spasm::reduce31(M[i * kLd + k] * M[k * kLd + kNB + tid], p,
                               invp);
      const int x = spasm::reduce31(-acc, p, invp) + (tid == i ? 1 : 0);
      M[i * kLd + kNB + tid] = spasm::reduce31(x, p, invp);
    }
    __syncthreads();
  }
  for (int idx = tid; idx < kNB * kNB; idx += kThreads) {
    const int i = idx / kNB;
    Vinv[idx] = M[i * kLd + kNB + (idx - i * kNB)];
  }
}

}  // namespace

// P: (n, 64) int32 panel at row stride ld (elements); piv_in / piv_out
// (n,) bool; lrows (64,) int32, lhas (64,) bool, Z and Vinv (64, 64)
// int32 (Vinv unused when rref); Pt (64 * n,) and rslot (64,) int32
// scratch.  One cooperative launch.
extern "C" int spasm_panel(const void* P, long long ld, int n,
                           const void* piv_in, void* lrows, void* lhas,
                           void* piv_out, void* Z, void* Vinv, void* Pt,
                           void* rslot, int p, int rref, void* stream) {
  static int max_blocks = 0;            // co-resident blocks on this card
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, panel_kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    max_blocks = per * sms;
  }
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  const int* a_P = static_cast<const int*>(P);
  const unsigned char* a_piv_in = static_cast<const unsigned char*>(piv_in);
  int* a_lrows = static_cast<int*>(lrows);
  unsigned char* a_lhas = static_cast<unsigned char*>(lhas);
  unsigned char* a_piv = static_cast<unsigned char*>(piv_out);
  int* a_Z = static_cast<int*>(Z);
  int* a_Vinv = static_cast<int*>(Vinv);
  int* a_Pt = static_cast<int*>(Pt);
  int* a_rslot = static_cast<int*>(rslot);
  void* args[] = {&a_P,  &ld,   &n,    &a_piv_in, &a_lrows, &a_lhas, &a_piv,
                  &a_Z,  &a_Vinv, &a_Pt, &a_rslot, &p,      &rref};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(panel_kernel), dim3(blocks), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
