// segment_sum.cu — equal-length segment sum for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segment_sum.py::segment_sum_equal (the
// pallas_call body _make_kernel: a (SEG_TILE, K, F_TILE) block summed over
// its K rows in VMEM). Computes, for every segment s of S,
//   out[s, :] = sum_{j < k} data[s * k + j, :]
// accumulated in float32 in row order, rounded to the data's dtype
// (float32, or bfloat16 round-to-nearest-even). The GraphSAGE step's fanout
// means are this sum times 1 / k. Spec:
// repro_torch/kernels/ref.py::segment_sum_equal, which this matches bit for
// bit.
//
// What bounds it on this card: bytes, the (S * k, F) input read once and the
// (S, F) output written once; one add per element read.
//
// What the design does about it: one thread per (segment, column), or per
// (segment, four columns) with 16-byte loads when the data is float32 with
// F % 4 == 0 and 16-byte aligned. Neighbouring threads take neighbouring
// columns, so each of the k row reads is coalesced, and the sum stays in a
// register: the sequential loop over k replaces the Pallas kernel's
// sequential grid, and nothing carries between blocks. A grid-stride loop
// over S * F keeps a fixed grid busy whatever S is. No padding to the TPU's
// SEG_TILE or F_TILE. __fadd_rn and -fmad=false keep every rounding where
// the plain version has it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "float_io.cuh"

namespace {

using rudder::load_f;
using rudder::store_f;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// Scalar path: any element type, any F.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(int64_t S, int k, int F, const T* __restrict__ data,
                       T* __restrict__ out) {
  const int64_t total = S * F;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t s = i / F;
    const int c = (int)(i - s * F);
    const T* row = data + s * k * F + c;
    float acc = load_f(row);
    for (int j = 1; j < k; ++j) acc = __fadd_rn(acc, load_f(row + (int64_t)j * F));
    store_f(out + i, acc);
  }
}

// float32 with F % 4 == 0 and aligned rows: four columns per thread.
__global__ void __launch_bounds__(kThreads)
    segment_sum_vec_kernel(int64_t S, int k, int F,
                           const float* __restrict__ data,
                           float* __restrict__ out) {
  const int F4 = F / 4;
  const int64_t total = S * F4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float4* d4 = reinterpret_cast<const float4*>(data);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t s = i / F4;
    const int c = (int)(i - s * F4);
    const float4* row = d4 + s * k * F4 + c;
    float4 acc = __ldg(row);
    for (int j = 1; j < k; ++j) {
      const float4 r = __ldg(row + (int64_t)j * F4);
      acc.x = __fadd_rn(acc.x, r.x);
      acc.y = __fadd_rn(acc.y, r.y);
      acc.z = __fadd_rn(acc.z, r.z);
      acc.w = __fadd_rn(acc.w, r.w);
    }
    o4[i] = acc;
  }
}

int grid_for(int64_t items) {
  const int64_t want = (items + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// out (S, F) = data (S * k, F) summed over every k consecutive rows, on
// `stream`. `bf16` selects bfloat16 data and output (else float32).
// Pointers are device pointers of contiguous tensors. Returns the
// cudaError_t of the launch, or 0 when there is nothing to launch.
extern "C" int rudder_segment_sum(int64_t S, int k, int F, int bf16,
                                  const void* data, void* out, void* stream) {
  if (S <= 0 || k <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    segment_sum_kernel<__nv_bfloat16><<<grid_for(S * F), kThreads, 0, s>>>(
        S, k, F, static_cast<const __nv_bfloat16*>(data),
        static_cast<__nv_bfloat16*>(out));
  } else if (F % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    segment_sum_vec_kernel<<<grid_for(S * (F / 4)), kThreads, 0, s>>>(
        S, k, F, static_cast<const float*>(data), static_cast<float*>(out));
  } else {
    segment_sum_kernel<float><<<grid_for(S * F), kThreads, 0, s>>>(
        S, k, F, static_cast<const float*>(data), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
