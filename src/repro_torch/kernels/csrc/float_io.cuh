// float_io.cuh — float32 / bfloat16 element access with float32 arithmetic,
// shared by the GraphSAGE step's kernels (gather_mean.cu, segment_sum.cu).
//
// A bfloat16 load widens exactly (the 16 bits become the high half of a
// float32); a bfloat16 store rounds to nearest even, as
// Tensor.to(torch.bfloat16) does.
//
// Vec<T, V> moves V consecutive elements of T as one access: 16 bytes (four
// float32 or eight bfloat16, the pointer 16-byte aligned) when
// V * sizeof(T) == 16, one element when V == 1. `load` returns the raw
// bits, so a thread can keep several loads in flight in few registers and
// widen each element only when it adds it (`get`).

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

// v rounded to T and widened back: the value a T store of v would hold.
__device__ __forceinline__ float round_to(const float*, float v) { return v; }

__device__ __forceinline__ float round_to(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

template <typename T, int V>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const T* p) { return load_f(p); }
  static __device__ __forceinline__ float get(const Raw& r, int) { return r; }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
    store_f(p, v[0]);
  }
};

template <>
struct Vec<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float get(const Raw& r, int i) {
    return __uint_as_float(word(r, i));
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // Element i is the low (even i) or high (odd i) half of word i / 2.
  static __device__ __forceinline__ float get(const Raw& r, int i) {
    const uint32_t w = word(r, i >> 1);
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

}  // namespace rudder
