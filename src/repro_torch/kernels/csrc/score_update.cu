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
// What bounds it on this card: bytes. 4 + 1 (+ 4) bytes read and 4
// written per slot, three float operations.
//
// What the design does about it: a grid-stride loop over each PE's row
// (blockIdx.y = PE), neighbouring threads on neighbouring slots, so every
// load and store is coalesced. The Pallas kernel padded rows to (64, 128)
// tiles with lanes that could not be stale; here the ragged edge is
// masked and nothing is padded. Stale counts: one __syncthreads_count
// per block and iteration, one atomicAdd per block into the (P,) int32
// output, which the wrapper zeroes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prefetch_state.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerRow = 1024;

__global__ void __launch_bounds__(kThreads)
    score_update_kernel(int64_t N, const float* __restrict__ scores,
                        const uint8_t* __restrict__ accessed,
                        const float* __restrict__ weights,
                        float* __restrict__ out, int32_t* __restrict__ stale,
                        rudder::Policy pol) {
  const int p = blockIdx.y;
  const int64_t row = (int64_t)p * N;
  int count = 0;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < N;
       base += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = base + threadIdx.x;
    int is_stale = 0;
    if (j < N) {
      const float w = weights != nullptr ? weights[row + j] : 1.0f;
      const float v =
          rudder::score_round(scores[row + j], accessed[row + j] != 0, w, pol);
      out[row + j] = v;
      is_stale = v < pol.threshold;
    }
    count += __syncthreads_count(is_stale);
  }
  if (threadIdx.x == 0 && count) atomicAdd(stale + p, count);
}

}  // namespace

// out (P, N) float32 and stale (P,) int32 (zeroed by the caller) from
// scores (P, N) float32, accessed (P, N) uint8 and weights (P, N) float32
// or null, on `stream`. mode: 0 accumulate, 1 reset, 2 capped. Pointers
// are device pointers of contiguous tensors. Returns the cudaError_t of
// the launch, or 0.
extern "C" int rudder_score_update(int P, int64_t N, const float* scores,
                                   const uint8_t* accessed,
                                   const float* weights, float* out,
                                   int32_t* stale, float increment,
                                   float decay, float threshold,
                                   float score_cap, int mode, void* stream) {
  if (P <= 0 || N <= 0) return 0;
  rudder::Policy pol;
  pol.increment = increment;
  pol.decay = decay;
  pol.threshold = threshold;
  pol.score_cap = score_cap;
  pol.initial_score = 0.0f;  // a scoring round places nothing
  pol.mode = mode;
  const int64_t want = (N + kThreads - 1) / kThreads;
  const int64_t blocks = want < kMaxBlocksPerRow ? want : kMaxBlocksPerRow;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(P));
  score_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      N, scores, accessed, weights, out, stale, pol);
  return static_cast<int>(cudaGetLastError());
}
