// Asynchronous copies from device to shared memory (cp.async, sm_80 and
// later), shared by the reduced deposition and the fused gather: a copy
// spends no registers and lands while the thread goes on; a thread commits
// its copies as a group and waits on its groups.
#pragma once

#include <cuda_runtime.h>

namespace mpic {

// copy BYTES (4, or 16 with both addresses 16-byte aligned)
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  static_assert(BYTES == 4 || BYTES == 16, "these kernels copy 4 or 16 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mpic
