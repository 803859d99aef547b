// score_update.cu — the scoring round of the staged pipeline's engine,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/score_update.py::score_policy_update_batch
// (the policy zoo: accumulate, reset or capped, with increment, decay,
// threshold, score_cap and optional per-slot weights) and its two fixed-
// policy forms ::score_update_batch (the default constants) and
// ::score_update (one buffer, P = 1); all three launch this kernel.
// Computes, for scores and accessed marks (P, N) [and weights (P, N)]:
//   new[p, j]  = score_round(s, accessed, w)   (w = 1 when unweighted)
//   stale[p]   = #{ j : new[p, j] < threshold }
// Spec: repro_torch/kernels/ref.py::score_policy_update_batch.
//
// The rule is prefetch_state.cuh's score_round, the one the fused steps
// use, so every scoring round of the port rounds alike: explicit
// round-to-nearest intrinsics, built with -fmad=false (a score that lands
// on the 0.95 threshold after one ulp of FMA drift would flip a
// replacement). increment * 1.0f is exact, so an unweighted launch takes
// w = 1 and no branch. capped mode's fminf equals the reference's
// jnp.minimum on every non-NaN input; scores are never NaN.
//
// What bounds it on this card: bytes, 4 + 1 (+ 4) read and 4 written per
// slot, three float operations; at the staged shape (P = 4, N ≈ 12.6k,
// 455 KB) that is far below one launch's latency, so the design is about
// doing the round in one device operation with few steps.
//
// What the design does about it. Grid (kCluster, P), one thread-block
// cluster of kCluster blocks per row: block b of the cluster takes the
// b-th of kCluster equal runs of the row's 16-byte groups of 4 slots (a
// float4 load of scores, and of weights, a 4-byte load of the marks, a
// float4 store), kGroups groups a thread a pass, all loaded before any is
// used, neighbouring threads on neighbouring groups. A row's slots before
// its first 16-byte boundary and after its last are taken one at a time
// by the first and the last block. The stale count is a warp and a block
// reduction, then the cluster's: block 0 adds the other blocks' counts
// from their shared memory (DSMEM) after a cluster barrier and writes
// stale[p] with a plain store, and a second barrier keeps those counts
// alive until it has. No scratch, no atomic, no zero-filled output: one
// kernel is the whole call. (The A/B of scripts/staged_hooks_ab.py set
// the sizes: at the staged shape every cluster of 8 or 16 blocks of 256 or
// 512 threads takes 0.0031-0.0032 ms alone, the launch's floor; on a row
// of 300,001 slots 16 blocks of 512 threads x 4 groups take 0.0065 ms
// against 0.0141 for 8 of 256 x 2. One block a row, or blocks meeting
// through a ticket of returning atomics, took 0.0028-0.0034 at the staged
// shape.) The 16-byte path needs 16-byte aligned scores,
// weights and output and 4-byte aligned marks (the wrapper checks and
// passes `vec`); otherwise each block takes its run of slots one at a
// time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prefetch_state.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCluster = 16;  // blocks a row (a non-portable cluster size)
constexpr int kThreads = 512;
constexpr int kGroups = 4;    // 4-slot groups a thread takes a pass

__device__ __forceinline__ float weight_of(const float* w, int64_t at) {
  return w != nullptr ? w[at] : 1.0f;
}

__device__ __forceinline__ int round_one(const float* scores, const uint8_t* accessed,
                                         const float* weights, float* out, int64_t at,
                                         const rudder::Policy& pol) {
  const float v = rudder::score_round(scores[at], accessed[at] != 0,
                                      weight_of(weights, at), pol);
  out[at] = v;
  return v < pol.threshold;
}

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    score_update_kernel(int64_t N, const float* __restrict__ scores,
                        const uint8_t* __restrict__ accessed,
                        const float* __restrict__ weights,
                        float* __restrict__ out, int32_t* __restrict__ stale,
                        rudder::Policy pol) {
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_count;
  const cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int p = blockIdx.y;
  const int t = threadIdx.x;
  const int64_t row = static_cast<int64_t>(p) * N;
  int count = 0;
  if (kVec) {
    // Slots [head, head + 4 * nvec) of the row are 16-byte groups.
    const int64_t lead = (4 - (row & 3)) & 3;
    const int head = static_cast<int>(lead < N ? lead : N);
    const int64_t nvec = (N - head) >> 2;
    const int64_t tail0 = head + 4 * nvec;
    if (b == 0 && t < head) count += round_one(scores, accessed, weights, out, row + t, pol);
    if (b == kCluster - 1 && t < N - tail0) {
      count += round_one(scores, accessed, weights, out, row + tail0 + t, pol);
    }
    const int64_t run = (nvec + kCluster - 1) / kCluster;
    const int64_t g1 = (b + 1) * run < nvec ? (b + 1) * run : nvec;
    const float4* s4 = reinterpret_cast<const float4*>(scores + row + head);
    const float4* w4 = reinterpret_cast<const float4*>(weights + row + head);
    const uint32_t* a4 = reinterpret_cast<const uint32_t*>(accessed + row + head);
    float4* o4 = reinterpret_cast<float4*>(out + row + head);
    for (int64_t g0 = b * run + t; g0 < g1; g0 += kThreads * kGroups) {
      float4 s[kGroups], w[kGroups];
      uint32_t a[kGroups];
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int64_t g = g0 + static_cast<int64_t>(i) * kThreads;
        if (g < g1) {
          s[i] = s4[g];
          a[i] = a4[g];
          w[i] = weights != nullptr ? w4[g] : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
        }
      }
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int64_t g = g0 + static_cast<int64_t>(i) * kThreads;
        if (g < g1) {
          float4 v;
          v.x = rudder::score_round(s[i].x, (a[i] & 0xffu) != 0, w[i].x, pol);
          v.y = rudder::score_round(s[i].y, (a[i] & 0xff00u) != 0, w[i].y, pol);
          v.z = rudder::score_round(s[i].z, (a[i] & 0xff0000u) != 0, w[i].z, pol);
          v.w = rudder::score_round(s[i].w, (a[i] & 0xff000000u) != 0, w[i].w, pol);
          o4[g] = v;
          count += (v.x < pol.threshold) + (v.y < pol.threshold) +
                   (v.z < pol.threshold) + (v.w < pol.threshold);
        }
      }
    }
  } else {
    const int64_t run = (N + kCluster - 1) / kCluster;
    const int64_t j1 = (b + 1) * run < N ? (b + 1) * run : N;
    for (int64_t j = b * run + t; j < j1; j += kThreads) {
      count += round_one(scores, accessed, weights, out, row + j, pol);
    }
  }

  // The stale count: warp, block, then cluster (block 0 reads the others'
  // s_count through DSMEM between two cluster barriers).
  count = __reduce_add_sync(0xffffffffu, count);
  if ((t & 31) == 0) s_warp[t >> 5] = count;
  __syncthreads();
  if (t < 32) {
    count = t < kThreads / 32 ? s_warp[t] : 0;
    count = __reduce_add_sync(0xffffffffu, count);
    if (t == 0) s_count = count;
  }
  cluster.sync();
  if (b == 0 && t < 32) {
    int c = t < kCluster ? *cluster.map_shared_rank(&s_count, t) : 0;
    c = __reduce_add_sync(0xffffffffu, c);
    if (t == 0) stale[p] = c;
  }
  cluster.sync();
}

template <bool kVec>
int launch(dim3 grid, cudaStream_t s, int64_t N, const float* scores,
           const uint8_t* accessed, const float* weights, float* out,
           int32_t* stale, const rudder::Policy& pol) {
  if (kCluster > 8) {  // a non-portable cluster size, allowed once
    static const cudaError_t allowed = cudaFuncSetAttribute(
        score_update_kernel<kVec>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
  }
  score_update_kernel<kVec><<<grid, kThreads, 0, s>>>(N, scores, accessed, weights, out,
                                                      stale, pol);
  return 0;
}

}  // namespace

// out (P, N) float32 and stale (P,) int32 from scores (P, N) float32,
// accessed (P, N) uint8 and weights (P, N) float32 or null, on `stream`.
// mode: 0 accumulate, 1 reset, 2 capped. vec: scores, weights and out are
// 16-byte aligned and accessed 4-byte aligned. Pointers are device
// pointers of contiguous tensors. Returns the cudaError_t of the launch,
// or 0.
extern "C" int rudder_score_update(int P, int64_t N, const float* scores,
                                   const uint8_t* accessed,
                                   const float* weights, float* out,
                                   int32_t* stale, float increment,
                                   float decay, float threshold,
                                   float score_cap, int mode, int vec,
                                   void* stream) {
  if (P <= 0 || N <= 0) return 0;
  rudder::Policy pol;
  pol.increment = increment;
  pol.decay = decay;
  pol.threshold = threshold;
  pol.score_cap = score_cap;
  pol.initial_score = 0.0f;  // a scoring round places nothing
  pol.mode = mode;
  const dim3 grid(kCluster, static_cast<unsigned>(P));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = vec ? launch<true>(grid, s, N, scores, accessed, weights, out, stale, pol)
                      : launch<false>(grid, s, N, scores, accessed, weights, out, stale, pol);
  return err ? err : static_cast<int>(cudaGetLastError());
}
