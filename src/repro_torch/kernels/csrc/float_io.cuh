// float_io.cuh — float32 / bfloat16 element access with float32 arithmetic,
// shared by the GraphSAGE step's kernels (gather_mean.cu, segment_sum.cu).
//
// A bfloat16 load widens exactly (the 16 bits become the high half of a
// float32); a bfloat16 store rounds to nearest even, as
// Tensor.to(torch.bfloat16) does.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rudder {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace rudder
