// The candidate exchange of the cluster kernels (B2 `sweep_cluster`, B4
// `panel_cluster`), for Hopper (sm_90a).
//
// A step of either kernel needs a cluster-wide minimum (the leftmost
// pivot column, the first available pivot row) and the winner's data.
// Each block writes one message (its candidate and the values that come
// with it) into shared memory; `send_to_all` copies it with the Tensor
// Memory Accelerator's bulk copy into slot `me` of every block's inbox,
// and each copy completes on the receiver's mbarrier, which counts the
// bytes in.  A receiver that has waited on its barrier holds every
// block's message in its own shared memory: one exchange per step, no
// cluster barrier.  (Plain DSMEM stores with a remote arrive per store,
// and one cluster barrier per step, were both slower in B4.)
#pragma once

namespace spasm {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of shared location `a` in block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// One-arrival mbarrier; then a fence so the cluster's copies may target
// it (a cluster.sync() must follow before any block sends).
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Called by threads 0..63 of the block (and only them) once they have
// written *out: copies it into in_me (this block's slot of the inbox,
// at the same shared address in every block) of all kBlocks blocks,
// completing on each receiver's `bar`; thread 0 arms this block's own
// `bar` for the kBlocks messages it will receive.  Msg is 16-byte aligned
// and a multiple of 16 bytes.
template <int kBlocks, class Msg>
__device__ __forceinline__ void send_to_all(const Msg* out, Msg* in_me,
                                            unsigned long long* bar) {
  static_assert(sizeof(Msg) % 16 == 0, "bulk copies move 16-byte units");
  static_assert(kBlocks <= 32, "one lane per receiver");
  const int tid = threadIdx.x;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, 64;" ::: "memory");
  const unsigned b = smem_addr(bar);
  if (tid == 0)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
        :: "r"(b), "r"(static_cast<int>(sizeof(Msg)) * kBlocks)
        : "memory");
  if (tid < kBlocks) {                  // lane d copies to block d
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::"
        "complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(cluster_addr(smem_addr(in_me), tid)), "r"(smem_addr(out)),
           "r"(static_cast<int>(sizeof(Msg))), "r"(cluster_addr(b, tid))
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
}

// Before a block exits: its own copies have finished reading their
// sources (threads 0..kBlocks-1 issued them).
template <int kBlocks>
__device__ __forceinline__ void sends_done() {
  if (threadIdx.x < kBlocks)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

}  // namespace spasm
