// The launch sizing of the persistent kernels (awac_persistent.cu,
// mcm_persistent.cu): a cooperative grid of every block that can be
// resident at once, so that a grid sync never waits on a block that
// cannot be scheduled.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace coop {

constexpr int kMaxDevices = 64;

// Blocks of `threads` threads per SM from the occupancy query for `kernel`,
// times the SM count of the current device. Queried at the first launch on
// a device and kept in cache[device] (0: not queried yet); two threads that
// query at once store the same value.
template <typename Kernel>
int grid_blocks(Kernel kernel, int threads, std::atomic<int>* cache,
                int* blocks) {
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int g = cache[dev].load(std::memory_order_relaxed);
  if (g == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)))
      return err;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev)))
      return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, 0)))
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    g = sms * per_sm;
    cache[dev].store(g, std::memory_order_relaxed);
  }
  *blocks = g;
  return cudaSuccess;
}

}  // namespace coop
