// fused_frontier_step.cu — the single-launch prefetch step for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_step.py::fused_frontier_step_pallas
// (the pallas_call body, _make_frontier_kernel + _fused_body): per trainer
// PE, dedup the row-sorted frontier, close the scoring round, run the
// replacement round (free slots first, then stale, in candidate order) and
// probe the deduplicated remote frontier against the post-replace buffer,
// emitting one per-position code (0 local or duplicate, 1 remote miss,
// 2 + slot remote hit). Spec: repro_torch/kernels/ref.py::fused_step_core
// and ::fused_frontier_step; the row sort before and the miss compaction
// after stay torch.sort in the wrapper (kernels/fused_step.py).
//
// What bounds it on this card: bytes. The launch reads the sorted frontier
// (P x Mt int32), one part_of entry per position and the (P, C) state, and
// writes the (P, Mt) code plus the state; per position it does a handful of
// integer operations, so at P = 4, Mt = 522,000 it is some 20-30 MB of
// traffic — single-digit microseconds at 3.35 TB/s — and far below any
// compute roof.
//
// What the design does about it: the TPU kernel builds dense (Mt, C),
// (K, C) and (K, K) comparison tiles in VMEM; here that would be ~10^10
// compares. Ids on this path are local node indices < N = len(part_of), so
// each PE gets a direct-mapped index over the id space instead:
//   slot_of[p][id]    slot holding id (or -1): membership, freshness and
//                     the probe become one load each;
//   cand_first[p][id] earliest candidate position holding id (atomicMin):
//                     first-occurrence dedup of the candidate list.
// Both are (P, N) int32 scratch, filled by the wrapper (-1 and INT_MAX).
// The maps rely on resident ids being unique per PE, which the replacement
// round guarantees (it only admits non-resident, first-occurrence ids).
//
// Two kernels on the current stream:
//   (A) prefetch_state_kernel (prefetch_state.cuh), one block per PE:
//       score; free/stale slot ranks and fresh candidate ranks by
//       block-wide scans over contiguous per-thread chunks (ranks follow
//       slot and candidate order); placement, updating slot_of for the
//       probe. Only P blocks: the state is small (C ~ 12.6k, K ~ 25k per
//       PE).
//   (B) frontier_probe_kernel, grid (ceil(Mt / 256), P): first-occurrence
//       and remote masks, the probe, code, and accessed marks for hit slots
//       (several threads may write the same 1 to a slot: a benign race).
//
// Scores are bit-exact with the plain version: every float operation is
// written as an explicit round-to-nearest intrinsic and the file is built
// with -fmad=false, so no multiply-add is contracted into an FMA (a score
// that lands on the 0.95 stale threshold would otherwise flip a
// replacement).

#include <cuda_runtime.h>
#include <stdint.h>

#include "prefetch_state.cuh"

namespace {

constexpr int kProbeThreads = 256;

// (B) Dedup, probe and code over the row-sorted frontier.
__global__ void __launch_bounds__(kProbeThreads)
    frontier_probe_kernel(int C, int Mt, int N, int aug_stride,
                          const int32_t* __restrict__ aug,
                          const int32_t* __restrict__ sk,
                          const int32_t* __restrict__ part_of,
                          const int32_t* __restrict__ slot_of,
                          int32_t* __restrict__ code,
                          uint8_t* __restrict__ acc3) {
  const int p = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Mt) return;
  const bool active_probe =
      (aug[(int64_t)p * aug_stride + (aug_stride - 1)] & 4) != 0;
  const int64_t row = (int64_t)p * Mt;
  const int32_t v = sk[row + m];
  const int32_t prev = m > 0 ? sk[row + m - 1] : -1;
  int32_t out = 0;
  if (v >= 0 && v < N && v != prev && part_of[v] != p) {
    out = 1;
    if (active_probe) {
      const int32_t slot = slot_of[(int64_t)p * N + v];
      if (slot >= 0) {
        out = slot + 2;
        acc3[(int64_t)p * C + slot] = 1;
      }
    }
  }
  code[row + m] = out;
}

}  // namespace

// Launches (A) then (B) on `stream`. Pointers are device pointers of
// contiguous tensors; `weights`, `w2` and `node_weights` may be null (the
// unweighted policies). Returns the cudaError_t of the first failed launch,
// or 0.
extern "C" int rudder_fused_frontier_step(
    int P, int C, int K, int Mt, int N, const int32_t* aug, const int32_t* sk,
    const int32_t* ids, const float* scores, const uint8_t* valid,
    const uint8_t* accessed, const uint8_t* in_cap, const float* weights,
    const int32_t* part_of, const int32_t* cand, const float* node_weights,
    int32_t* ids2, float* s2, uint8_t* valid2, uint8_t* acc3, float* w2,
    int32_t* code, uint8_t* placed, int32_t* slot_pos, int32_t* slot_of,
    int32_t* cand_first, int32_t* rank_slot, float increment, float decay,
    float threshold, float score_cap, float initial_score, int mode,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0) return 0;
  const rudder::Policy pol{increment, decay, threshold, score_cap,
                           initial_score, mode};
  const int aug_stride = Mt + 1;
  rudder::prefetch_state_kernel<rudder::PackedGates>
      <<<P, rudder::kStateThreads, 0, s>>>(
          C, K, N, rudder::PackedGates{aug, aug_stride}, ids, scores, valid,
          accessed, in_cap, weights, cand, nullptr, node_weights, ids2, s2,
          valid2, acc3, w2, placed, slot_pos, slot_of, cand_first, rank_slot,
          pol);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Mt > 0) {
    dim3 grid((Mt + kProbeThreads - 1) / kProbeThreads, P);
    frontier_probe_kernel<<<grid, kProbeThreads, 0, s>>>(
        C, Mt, N, aug_stride, aug, sk, part_of, slot_of, code, acc3);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
