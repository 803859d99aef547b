// gather_rows.cu — per-shard feature-row gather for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gather_rows.py::gather_rows_batch and
// ::gather_rows (the pallas_call bodies, _gather_kernel with the
// scalar-prefetched row index maps). Computes
//   out[p, i, :] = tables[p, idx[p, i], :]
// for a float32 (P, N, F) table and an int32 (P, M) index; the single-table
// form is the P = 1 view, through the same entry point. Spec:
// repro_torch/kernels/ref.py::gather_rows_batch / ::gather_rows.
//
// The single-table form also takes an optional int32 node -> row map:
//   out[i, :] = table[map[idx[i]], :]
// so the feature store's training gather reads its node ids' rows of the
// flat table in request order, the map lookup inside the launch (one more
// 4-byte load per row; the map is the store's device_view loc).
//
// What bounds it on this card: bytes, 2 * M * F * 4 per PE (each gathered
// row read once and written once) plus the index; there is no arithmetic.
//
// What the design does about it: one warp per output row, so each row is
// one run of neighbouring addresses read by neighbouring lanes; 16-byte
// loads and stores (float4) when F % 4 == 0 and both tables and out are
// 16-byte aligned (F = 128 for papers, 100 for products), 4-byte ones
// otherwise (F = 602 for reddit); a grid-stride loop over the P * M rows
// keeps a fixed grid of resident warps busy whatever M is. The Pallas
// kernel's scalar prefetch of the indices becomes one broadcast load of
// idx per warp. Out-of-range indices are the caller's error (the feature
// store checks them on the host before any gather).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <bool kVec, bool kMap>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(int64_t rows_total, int M, int64_t N, int F,
                       const float* __restrict__ tables,
                       const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ map,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = warp; r < rows_total; r += n_warps) {
    const int64_t p = r / M;
    const int64_t row =
        kMap ? (int64_t)__ldg(map + idx[r]) : (int64_t)idx[r];
    const float* src = tables + (p * N + row) * F;
    float* dst = out + r * F;
    if (kVec) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int c = lane; c < F / 4; c += 32) d4[c] = __ldg(s4 + c);
    } else {
      for (int c = lane; c < F; c += 32) dst[c] = __ldg(src + c);
    }
  }
}

template <bool kMap>
void launch(int blocks, cudaStream_t s, bool vec, int64_t rows_total, int M,
            int64_t N, int F, const float* tables, const int32_t* idx,
            const int32_t* map, float* out) {
  if (vec) {
    gather_rows_kernel<true, kMap><<<blocks, kThreads, 0, s>>>(
        rows_total, M, N, F, tables, idx, map, out);
  } else {
    gather_rows_kernel<false, kMap><<<blocks, kThreads, 0, s>>>(
        rows_total, M, N, F, tables, idx, map, out);
  }
}

}  // namespace

// out (P, M, F) = tables (P, N, F) gathered at idx (P, M), on `stream`; with
// a map (P = 1 only), at rows map[idx]. Pointers are device pointers of
// contiguous tensors; map may be null. Returns the cudaError_t of the
// launch, or 0.
extern "C" int rudder_gather_rows(int P, int64_t N, int M, int F,
                                  const float* tables, const int32_t* idx,
                                  const int32_t* map, float* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows_total = (int64_t)P * M;
  if (rows_total <= 0 || F <= 0) return 0;
  const int64_t warps_per_block = kThreads / 32;
  const int64_t want = (rows_total + warps_per_block - 1) / warps_per_block;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  const bool vec = F % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(tables) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (map != nullptr) {
    launch<true>(blocks, s, vec, rows_total, M, N, F, tables, idx, map, out);
  } else {
    launch<false>(blocks, s, vec, rows_total, M, N, F, tables, idx, map, out);
  }
  return static_cast<int>(cudaGetLastError());
}
