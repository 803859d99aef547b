// segment_sum.cu — equal-length segment sum for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segment_sum.py::segment_sum_equal (the
// pallas_call body _make_kernel: a (SEG_TILE, K, F_TILE) block summed over
// its K rows in VMEM). Computes, for every segment s of S,
//   out[s, :] = sum_{j < k} data[s * k + j, :]
// accumulated in float32 in row order and rounded to the data's dtype
// (float32, or bfloat16 round-to-nearest-even); with a scale, that rounded
// sum times the float32 scale, in float32, rounded to the dtype again (one
// rounding in float32): the GraphSAGE fanout mean (scale 1 / k) in one
// launch. Spec: repro_torch/kernels/ref.py::segment_sum_equal, which this
// matches bit for bit.
//
// What bounds it on this card: DRAM bytes, the (S * k, F) input read once
// and the (S, F) output written once; one add per element read. Phase 3b's
// layer-2 mean (x_n2, 186.5 MB) is bound at 0.0557 ms; phase 3's layer-1
// mean (x_n1, 8.8 MB) sits in L2 and takes about the launch's own latency.
//
// What the design does about it. One thread per (segment, 16-byte column)
// pair: neighbouring threads take neighbouring columns, so each of the k
// row reads is coalesced, and the sum stays in registers: the loop over k
// replaces the Pallas kernel's sequential grid. A segment's k rows are one
// contiguous run of k * F elements; the loads do not depend on the adds,
// and the loop is unrolled 8 deep so that they are in flight together (at
// x_n2 the kernel reads at 89-92% of the DRAM rate; 16 deep was slower).
// The adds stay in row order. 16-byte loads and stores: float4 for float32
// with F % 4 == 0, eight bfloat16 with F % 8 == 0, when data and output
// are 16-byte aligned; one element a load otherwise. The optional scale in
// the epilogue makes the fanout mean one launch, where it was the sum, a
// host-to-device copy of 1 / k (which waited on the stream) and a
// multiply. No padding to the TPU's SEG_TILE or F_TILE. __fadd_rn /
// __fmul_rn and -fmad=false keep every rounding where the plain version
// has it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "float_io.cuh"

namespace {

using rudder::Vec;

constexpr int kThreads = 256;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(int64_t S, int k, int W, bool scaled, float scale,
                       const T* __restrict__ data, T* __restrict__ out) {
  using Io = Vec<T, V>;
  const int64_t item = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (item >= S * W) return;
  const int64_t s = item / W;
  const int F = W * V;
  const int offset = (int)(item - s * W) * V;  // the column
  const T* rows = data + s * k * F + offset;
  typename Io::Raw r = Io::load(rows);
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = Io::get(r, e);
#pragma unroll 8
  for (int j = 1; j < k; ++j) {
    r = Io::load(rows + (int64_t)j * F);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], Io::get(r, e));
  }
  if (scaled) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = __fmul_rn(rudder::round_to(data, acc[e]), scale);
  }
  Io::store(out + s * F + offset, acc);
}

template <typename T, int V>
int launch(int64_t S, int k, int F, bool scaled, float scale, const void* data,
           void* out, cudaStream_t s) {
  const int W = F / V;
  const int64_t blocks = (S * W + kThreads - 1) / kThreads;
  segment_sum_kernel<T, V><<<(unsigned)blocks, kThreads, 0, s>>>(
      S, k, W, scaled, scale, static_cast<const T*>(data), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (S, F) = data (S * k, F) summed over every k consecutive rows, on
// `stream`. `flags` bit 0: bfloat16 data and output (else float32); bit 1:
// multiply each rounded sum by `scale` (float32) and round again. Pointers
// are device pointers of contiguous tensors. Returns the cudaError_t of the
// launch, or 0 when there is nothing to launch.
extern "C" int rudder_segment_sum(int64_t S, int k, int F, float scale, int flags,
                                  const void* data, void* out, void* stream) {
  if (S <= 0 || k <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scaled = flags & 2;
  const bool wide = reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (flags & 1) {
    return wide && F % 8 == 0
               ? launch<__nv_bfloat16, 8>(S, k, F, scaled, scale, data, out, s)
               : launch<__nv_bfloat16, 1>(S, k, F, scaled, scale, data, out, s);
  }
  return wide && F % 4 == 0 ? launch<float, 4>(S, k, F, scaled, scale, data, out, s)
                            : launch<float, 1>(S, k, F, scaled, scale, data, out, s);
}
