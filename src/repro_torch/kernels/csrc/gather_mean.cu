// gather_mean.cu — GraphSAGE neighbour mean (gather + mean) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gather_mean.py::gather_mean (the pallas_call
// body _make_kernel, with the scalar-prefetched neighbour index maps).
// Computes, for every destination b of B,
//   out[b, :] = (sum_{j < K} table[idx[b, j], :]) * (1 / K)
// accumulated in float32 in neighbour order (acc = r0; acc = acc + rj),
// multiplied by the float32 value of 1 / K and rounded to the table's dtype
// (float32, or bfloat16 round-to-nearest-even). Spec:
// repro_torch/kernels/ref.py::gather_mean, which this matches bit for bit.
//
// What bounds it on this card: bytes. Each distinct table row read once,
// each output row written once, plus the (B, K) index; a handful of adds per
// element read, far below the card's scalar rate.
//
// What the design does about it: one warp per destination row, lanes across
// F, so each gathered row is one run of neighbouring addresses read by
// neighbouring lanes, and the K rows are summed in registers: no (B, K, F)
// block is ever written (the Pallas kernel's VMEM accumulator tile becomes a
// register per lane). 16-byte loads and stores (float4) when the table is
// float32 with F % 4 == 0 and 16-byte aligned, 4- or 2-byte ones otherwise;
// a grid-stride loop over B keeps a fixed grid of resident warps busy. The
// Pallas kernel's scalar prefetch of the indices becomes a broadcast load of
// idx per neighbour; repeated rows are L1/L2 hits. No padding of F to the
// TPU's F_TILE. __fadd_rn / __fmul_rn and -fmad=false keep every rounding
// where the plain version has it. Out-of-range indices are the caller's
// error, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "float_io.cuh"

namespace {

using rudder::load_f;
using rudder::store_f;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// Scalar path: any element type, any F.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    gather_mean_kernel(int64_t B, int K, int F, float inv_k,
                       const T* __restrict__ table, const I* __restrict__ idx,
                       T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t b = warp; b < B; b += n_warps) {
    const I* nbr = idx + b * K;
    for (int c = lane; c < F; c += 32) {
      float acc = load_f(table + (int64_t)__ldg(nbr) * F + c);
      for (int j = 1; j < K; ++j) {
        acc = __fadd_rn(acc, load_f(table + (int64_t)__ldg(nbr + j) * F + c));
      }
      store_f(out + b * F + c, __fmul_rn(acc, inv_k));
    }
  }
}

// float32 with F % 4 == 0 and aligned rows: one float4 per lane per step.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    gather_mean_vec_kernel(int64_t B, int K, int F, float inv_k,
                           const float* __restrict__ table,
                           const I* __restrict__ idx, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int F4 = F / 4;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int64_t b = warp; b < B; b += n_warps) {
    const I* nbr = idx + b * K;
    for (int c = lane; c < F4; c += 32) {
      float4 acc = __ldg(t4 + (int64_t)__ldg(nbr) * F4 + c);
      for (int j = 1; j < K; ++j) {
        const float4 r = __ldg(t4 + (int64_t)__ldg(nbr + j) * F4 + c);
        acc.x = __fadd_rn(acc.x, r.x);
        acc.y = __fadd_rn(acc.y, r.y);
        acc.z = __fadd_rn(acc.z, r.z);
        acc.w = __fadd_rn(acc.w, r.w);
      }
      acc.x = __fmul_rn(acc.x, inv_k);
      acc.y = __fmul_rn(acc.y, inv_k);
      acc.z = __fmul_rn(acc.z, inv_k);
      acc.w = __fmul_rn(acc.w, inv_k);
      o4[b * F4 + c] = acc;
    }
  }
}

int grid_for(int64_t rows) {
  const int64_t warps_per_block = kThreads / 32;
  const int64_t want = (rows + warps_per_block - 1) / warps_per_block;
  return (int)(want < kMaxBlocks ? want : kMaxBlocks);
}

template <typename I>
int launch(int64_t B, int K, int F, float inv_k, int bf16, const void* table,
           const void* idx, void* out, cudaStream_t s) {
  const int blocks = grid_for(B);
  const I* ix = static_cast<const I*>(idx);
  if (bf16) {
    gather_mean_kernel<__nv_bfloat16, I><<<blocks, kThreads, 0, s>>>(
        B, K, F, inv_k, static_cast<const __nv_bfloat16*>(table), ix,
        static_cast<__nv_bfloat16*>(out));
  } else if (F % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    gather_mean_vec_kernel<I><<<blocks, kThreads, 0, s>>>(
        B, K, F, inv_k, static_cast<const float*>(table), ix,
        static_cast<float*>(out));
  } else {
    gather_mean_kernel<float, I><<<blocks, kThreads, 0, s>>>(
        B, K, F, inv_k, static_cast<const float*>(table), ix,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (B, F) = mean over K of table (N, F) rows at idx (B, K), on `stream`.
// `bf16` selects a bfloat16 table and output (else float32); `idx64` int64
// indices (else int32); `inv_k` is the float32 value of 1 / K. Pointers are
// device pointers of contiguous tensors. Returns the cudaError_t of the
// launch, or 0 when there is nothing to launch.
extern "C" int rudder_gather_mean(int64_t B, int K, int F, float inv_k,
                                  int bf16, int idx64, const void* table,
                                  const void* idx, void* out, void* stream) {
  if (B <= 0 || K <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? launch<int64_t>(B, K, F, inv_k, bf16, table, idx, out, s)
               : launch<int32_t>(B, K, F, inv_k, bf16, table, idx, out, s);
}
