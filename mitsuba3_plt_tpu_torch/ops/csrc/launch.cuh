// The grid of a launch whose blocks loop over tiles of rays, shared by
// intersect_q.cu (B1, B2), intersect_sweep.cu (B11a, B11b, B11c, through
// q_row.cuh) and intersect_mxu.cu (B9).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace {

// Blocks a launch of kKernel (kThreads threads a block, a tile of kThreads
// rays at a time) runs for n rays: every tile, or at most kWaves grids of
// the blocks the card holds at once (per kernel and device, read once).
template <auto kKernel, int kThreads, int kWaves>
int grid_for(int n) {
  static int resident[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& cap = resident[dev & 63];
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads,
                                                  0);
    cap = std::max(1, sms * per_sm);
  }
  const int tiles = (n + kThreads - 1) / kThreads;
  return std::min(tiles, kWaves * cap);
}

}  // namespace
