// Per-device state of the launchers (B2's cluster, B3, B4).
//
// A function attribute set with cudaFuncSetAttribute, and an occupancy
// count read with cudaOccupancyMaxActiveBlocksPerMultiprocessor, belong
// to the current device's context.  One process may launch on several
// cards (a mesh, spasm_tpu_torch/parallel/), so what a launcher sets up
// once is kept once per device ordinal: a launch on a card whose context
// never had the attribute set would ask for more shared memory than that
// context allows and be refused.
#pragma once

#include <cuda_runtime.h>

namespace spasm {

constexpr int kMaxDevices = 64;

// The current device's ordinal in *dev (0 <= *dev < kMaxDevices).
inline cudaError_t current_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices))
    e = cudaErrorInvalidDevice;
  return e;
}

}  // namespace spasm
