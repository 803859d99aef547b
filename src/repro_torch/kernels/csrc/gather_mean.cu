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
// What bounds it on this card. DRAM bytes: each distinct table row read
// once, each output row written once, plus the (B, K) index (phase 3's
// launch: 44.8 MB, 0.0134 ms at 3.35 TB/s). But a minibatch's layer-2
// neighbours repeat: that launch reads 500,000 rows of which 82,105 are
// distinct (a destination's 25 sampled rows hold 16 distinct on average,
// a seed's ten sibling destinations 111 of 250), so five of every six row
// reads are re-reads that L1 or L2 serve. Served from L2 alone they would
// take 0.036 ms (the "L2 floor" of scripts/aggregation_ab.py: the distinct
// rows from DRAM, the rest at 7.07 TB/s); this kernel takes 0.026, so L1
// catches part of them. The adds are far below the card's scalar rate.
//
// What the design does about it. A group of G lanes per destination, G the
// row's 16-byte columns rounded up to a power of two (at most 32; 32 at
// F = 100 float32), lanes across F, so each gathered row is one run of
// neighbouring addresses; the groups of a block take consecutive
// destinations, siblings under one seed, side by side on one SM, where
// their shared rows meet in L1. The K rows are summed in registers (no
// (B, K, F) block; the Pallas kernel's VMEM accumulator becomes a register
// per lane) in neighbour order; each lane's row loads do not depend on its
// adds, so the compiler keeps several in flight. 16-byte loads and stores:
// float4 for float32 with F % 4 == 0, eight bfloat16 with F % 8 == 0, when
// table and output are 16-byte aligned; one element a load otherwise (a
// misaligned view, other widths). A fixed grid of resident warps strides
// over B.
//
// What was measured and left out (scripts/aggregation_ab.py, NVIDIA H100
// 80GB HBM3): more loads in flight a lane lose. This loop unrolled 4, 8 or
// 16 deep ran 8-13% slower than the first kernel at phase 3's shape, and a
// flat (destination, column) layout with no idle lane, the index tile
// staged in shared memory and batches of 1 to 16 loads ran from 4% to 2.5x
// slower: more loads in flight cut occupancy and put a
// destination's repeated rows in flight together, where L1 cannot serve
// the repeat. A tile that read its distinct rows once into shared memory
// (an in-block dedup through a hash table) ran 2x slower: its stages wait
// on each other. No padding of F to the TPU's F_TILE. __fadd_rn /
// __fmul_rn and -fmad=false keep every rounding where the plain version
// has it. Out-of-range indices are the caller's error, as in the
// reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "float_io.cuh"

namespace {

using rudder::Vec;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// A group of 2^g lanes (at most 32) per destination: lane l takes the
// row's V-element columns l, l + 2^g, ...; the groups stride over the
// destinations (a fixed grid of resident warps). Each lane's K row loads
// are independent of its adds, so the compiler keeps several in flight.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
    gather_mean_kernel(int64_t B, int K, int W, int g, float inv_k,
                       const T* __restrict__ table, const I* __restrict__ idx,
                       T* __restrict__ out) {
  using Io = Vec<T, V>;
  const int64_t thread = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int G = 1 << g;
  const int lane = (int)(thread & (G - 1));
  const int64_t n_groups = ((int64_t)gridDim.x * kThreads) >> g;
  const int F = W * V;
  for (int64_t b = thread >> g; b < B; b += n_groups) {
    const I* nbr = idx + b * K;
    for (int c = lane; c < W; c += G) {
      const T* col = table + c * V;
      typename Io::Raw r = Io::load(col + (int64_t)__ldg(nbr) * F);
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = Io::get(r, e);
      for (int j = 1; j < K; ++j) {
        r = Io::load(col + (int64_t)__ldg(nbr + j) * F);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], Io::get(r, e));
      }
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fmul_rn(acc[e], inv_k);
      Io::store(out + b * F + c * V, acc);
    }
  }
}

template <typename T, int V, typename I>
int launch(int64_t B, int K, int F, float inv_k, const void* table,
           const void* idx, void* out, cudaStream_t s) {
  const int W = F / V;
  int g = 0;  // lanes a destination: W rounded up to a power of two, at most 32
  while ((1 << g) < W && g < 5) ++g;
  const int64_t want = ((B << g) + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  gather_mean_kernel<T, V, I><<<blocks, kThreads, 0, s>>>(
      B, K, W, g, inv_k, static_cast<const T*>(table), static_cast<const I*>(idx),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename I>
int dispatch(int64_t B, int K, int F, float inv_k, bool bf16, const void* table,
             const void* idx, void* out, cudaStream_t s) {
  const bool wide = aligned16(table) && aligned16(out);
  if (bf16) {
    return wide && F % 8 == 0
               ? launch<__nv_bfloat16, 8, I>(B, K, F, inv_k, table, idx, out, s)
               : launch<__nv_bfloat16, 1, I>(B, K, F, inv_k, table, idx, out, s);
  }
  return wide && F % 4 == 0
             ? launch<float, 4, I>(B, K, F, inv_k, table, idx, out, s)
             : launch<float, 1, I>(B, K, F, inv_k, table, idx, out, s);
}

}  // namespace

// out (B, F) = mean over K of table (N, F) rows at idx (B, K), on `stream`.
// `flags` bit 0: a bfloat16 table and output (else float32); bit 1: int64
// indices (else int32). `inv_k` is the float32 value of 1 / K. Pointers are
// device pointers of contiguous tensors. Returns the cudaError_t of the
// launch, or 0 when there is nothing to launch.
extern "C" int rudder_gather_mean(int64_t B, int K, int F, float inv_k, int flags,
                                  const void* table, const void* idx, void* out,
                                  void* stream) {
  if (B <= 0 || K <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = flags & 1;
  return (flags & 2) ? dispatch<int64_t>(B, K, F, inv_k, bf16, table, idx, out, s)
                     : dispatch<int32_t>(B, K, F, inv_k, bf16, table, idx, out, s);
}
