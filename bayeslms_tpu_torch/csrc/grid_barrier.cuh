// The grid barrier of the port's persistent recurrences (csrc/lstm_train.cu,
// kernel rows 5 and 6; csrc/lstm2_fwd.cu, row 1): a counter in device
// memory, zeroed by the wrapper before the launch, that every CTA adds one
// to (red.release.gpu, after its stores) and waits on (ld.acquire.gpu). A
// barrier is only safe where every CTA of the grid is resident at once:
// the wrappers launch cooperatively, and a grid the card cannot hold is
// refused there, never run.

#pragma once

#include <cuda_runtime.h>

namespace {

// `target` = (barriers so far + 1) x CTAs. Every thread's stores before it
// are seen by every thread of every CTA after it.
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count),
                 "r"(1u)
                 : "memory");
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

}  // namespace
