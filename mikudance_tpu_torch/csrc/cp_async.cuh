// cp.async helpers shared by the kernels that stage tiles through shared
// memory, for Hopper (sm_90a).

#pragma once

#include <cuda_bf16.h>

namespace md_cp {

// 16 bytes global -> shared without passing through registers; `valid` false
// writes 16 zero bytes and reads nothing (src then only has to be a pointer
// into the tensor).
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace md_cp
