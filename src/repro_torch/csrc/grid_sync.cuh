// The grid-wide barrier of the persistent cooperative kernels K4
// (mcm_tiled.cu) and K6 spandiag (grid_pipeline.cu): an arrival counter in
// device memory, zero at launch, released and acquired at GPU scope. The
// launch is cooperative, so every CTA of the grid is resident and the
// barrier cannot hang on a CTA that never started.
#pragma once

#include <cuda_runtime.h>

namespace grid_sync_detail {

// ---- device primitives
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// ---- end of device primitives ----

}  // namespace grid_sync_detail

// Barrier number `phase` (1, 2, ...) of the whole grid over the arrival
// counter `bar`. Writes before it (any CTA) are seen after it by reads
// that bypass L1 (ld.global.cg).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned phase) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned target = phase * gridDim.x;
    while (grid_sync_detail::ld_acquire(bar) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}
