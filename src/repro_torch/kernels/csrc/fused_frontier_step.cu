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
// compares. Ids on this path are id_base plus a local node index below
// N = len(part_of), so each PE gets an index over the id space instead
// (the IdIndex of prefetch_state.cuh, direct maps keyed by id - id_base):
//   slot_of[p][id - id_base]    slot holding id (or -1): membership,
//                               freshness and the probe become one load
//                               each;
//   cand_first[p][id - id_base] earliest candidate position holding id
//                               (atomicMin): first-occurrence dedup of the
//                               candidate list.
// Both are (P, N) int32 scratch, filled by the wrapper (-1 and INT_MAX).
// Where P * N maps are past the wrapper's memory budget, the wide entry
// takes the index's sorted mode instead (binary searches over rows the
// wrapper sorts once per launch).
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
// Two entries: rudder_fused_frontier_step (int32 ids, id_base 0) and
// rudder_fused_frontier_step_wide (int64 ids at any id_base up to
// WIDE_ID_MAX), the port of fused_frontier_step_wide_pallas
// (src/repro/kernels/fused_step.py:873), whose (hi, lo) word planes int64
// replaces. The wide launch reads twice the frontier bytes (int64 keys).
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
template <typename Id, bool kSorted>
__global__ void __launch_bounds__(kProbeThreads)
    frontier_probe_kernel(int C, int K, int Mt, int N, int aug_stride,
                          rudder::IdIndex<Id> ix, const Id* __restrict__ aug,
                          const Id* __restrict__ sk,
                          const int32_t* __restrict__ part_of,
                          const Id* __restrict__ ids2,
                          const uint8_t* __restrict__ valid2,
                          const uint8_t* __restrict__ placed,
                          int32_t* __restrict__ code,
                          uint8_t* __restrict__ acc3) {
  const int p = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Mt) return;
  const bool active_probe =
      (aug[(int64_t)p * aug_stride + (aug_stride - 1)] & 4) != 0;
  const int64_t row = (int64_t)p * Mt;
  const Id v = sk[row + m];
  const Id prev = m > 0 ? sk[row + m - 1] : Id(-1);
  // Local node index of v (part_of is local-indexed from lo = id_base).
  const int64_t d = static_cast<int64_t>(v) - static_cast<int64_t>(ix.lo);
  int32_t out = 0;
  if (v >= 0 && d >= 0 && d < N && v != prev && part_of[d] != p) {
    out = 1;
    if (active_probe) {
      int32_t slot;
      if constexpr (kSorted) {
        slot = rudder::sorted_lookup(ix, p, C, K, v, ids2, valid2, placed);
      } else {
        slot = ix.slot_of[(int64_t)p * ix.span + d];
      }
      if (slot >= 0) {
        out = slot + 2;
        acc3[(int64_t)p * C + slot] = 1;
      }
    }
  }
  code[row + m] = out;
}

template <typename Id, bool kSorted>
int launch(int P, int C, int K, int Mt, int N, rudder::IdIndex<Id> ix,
           const Id* aug, const Id* sk, const Id* ids, const float* scores,
           const uint8_t* valid, const uint8_t* accessed, const uint8_t* in_cap,
           const float* weights, const int32_t* part_of, const Id* cand,
           const float* node_weights, Id* ids2, float* s2, uint8_t* valid2,
           uint8_t* acc3, float* w2, int32_t* code, uint8_t* placed,
           int32_t* slot_pos, int32_t* rank_slot, const rudder::Policy& pol,
           cudaStream_t s) {
  if (P <= 0) return 0;
  const int aug_stride = Mt + 1;
  rudder::prefetch_state_kernel<Id, kSorted, rudder::PackedGates<Id>>
      <<<P, rudder::kStateThreads, 0, s>>>(
          C, K, rudder::PackedGates<Id>{aug, aug_stride}, ix, ids, scores,
          valid, accessed, in_cap, weights, cand, nullptr, node_weights, ids2,
          s2, valid2, acc3, w2, placed, slot_pos, rank_slot, pol);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Mt > 0) {
    dim3 grid((Mt + kProbeThreads - 1) / kProbeThreads, P);
    frontier_probe_kernel<Id, kSorted><<<grid, kProbeThreads, 0, s>>>(
        C, K, Mt, N, aug_stride, ix, aug, sk, part_of, ids2, valid2, placed,
        code, acc3);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
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
  const rudder::Policy pol{increment, decay, threshold, score_cap,
                           initial_score, mode};
  const rudder::IdIndex<int32_t> ix{0, N, slot_of, cand_first};
  return launch<int32_t, false>(
      P, C, K, Mt, N, ix, aug, sk, ids, scores, valid, accessed, in_cap,
      weights, part_of, cand, node_weights, ids2, s2, valid2, acc3, w2, code,
      placed, slot_pos, rank_slot, pol, static_cast<cudaStream_t>(stream));
}

// The int64 entry: frontier ids lie in [id_base, id_base + N) or are
// negative padding. `sorted` = 0: (P, N) direct maps keyed by
// id - id_base, the sorted rows null. `sorted` = 1: the rows of
// rudder_fused_step_wide's sorted mode (fused_step.cu), the maps null.
extern "C" int rudder_fused_frontier_step_wide(
    int P, int C, int K, int Mt, int N, int64_t id_base, int sorted,
    const int64_t* aug, const int64_t* sk, const int64_t* ids,
    const float* scores, const uint8_t* valid, const uint8_t* accessed,
    const uint8_t* in_cap, const float* weights, const int32_t* part_of,
    const int64_t* cand, const float* node_weights, int64_t* ids2, float* s2,
    uint8_t* valid2, uint8_t* acc3, float* w2, int32_t* code, uint8_t* placed,
    int32_t* slot_pos, int32_t* slot_of, int32_t* cand_first,
    int32_t* rank_slot, const int64_t* res_sorted, const int64_t* res_order,
    const int64_t* cand_sorted, const int64_t* cand_order, int32_t* cand_slot,
    float increment, float decay, float threshold, float score_cap,
    float initial_score, int mode, void* stream) {
  const rudder::Policy pol{increment, decay, threshold, score_cap,
                           initial_score, mode};
  const rudder::IdIndex<int64_t> ix{id_base,     N,          slot_of,
                                    cand_first,  res_sorted, res_order,
                                    cand_sorted, cand_order, cand_slot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sorted) {
    return launch<int64_t, true>(
        P, C, K, Mt, N, ix, aug, sk, ids, scores, valid, accessed, in_cap,
        weights, part_of, cand, node_weights, ids2, s2, valid2, acc3, w2,
        code, placed, slot_pos, rank_slot, pol, s);
  }
  return launch<int64_t, false>(
      P, C, K, Mt, N, ix, aug, sk, ids, scores, valid, accessed, in_cap,
      weights, part_of, cand, node_weights, ids2, s2, valid2, acc3, w2, code,
      placed, slot_pos, rank_slot, pol, s);
}
