// fused_step.cu — the staged fused prefetch step for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_step.py::fused_step_pallas (the
// pallas_call body, _make_fused_kernel + _fused_body): per trainer PE,
// close the scoring round, run the replacement round (free slots first,
// then stale, in candidate order, first occurrences only) and probe the
// host-deduplicated queries against the post-replace buffer. It is the
// step of the ragged-seed-block device loop, where the host dedups each
// PE's frontier. Spec: repro_torch/kernels/ref.py::fused_step.
//
// What bounds it on this card: bytes, and below them the launch itself.
// The launch reads the (P, C) state, the (P, M) queries and the (P, K)
// candidates and writes the state, hit / hit_slot, placed and slot_pos; at
// P = 4, C ~ 23k, M ~ K ~ 22k that is a few MB, one to two microseconds at
// 3.35 TB/s, so the fixed cost of the launch and of the host around it
// dominates.
//
// What the design does about it: no dense (K, C) / (K, K) / (M, C) tiles.
// The IdIndex of prefetch_state.cuh answers membership, first occurrence
// and the probe with one load each (direct maps keyed by id - lo) or a
// binary search (sorted mode, for a launch whose id span is past the
// wrapper's memory budget for the maps). Two kernels on the current
// stream:
//   (A) prefetch_state_kernel, one cluster of 8 blocks per PE (score,
//       rank, place; it also writes n_placed and n_valid);
//   (B) probe_kernel, grid (ceil(M / 256), P): hit, hit_slot (-1 on a
//       miss) and accessed marks for hit slots (several threads may write
//       the same 1 to a slot: a benign race).
// Two entries: rudder_fused_step (int32 ids, direct maps over [0, N)) and
// rudder_fused_step_wide (int64 ids, either mode), the port of
// fused_step_wide_pallas (src/repro/kernels/fused_step.py:445), whose
// (hi, lo) word planes int64 replaces.
// Bit-exact scores: see prefetch_state.cuh (-fmad=false, _rn intrinsics).

#include <cuda_runtime.h>
#include <stdint.h>

#include "prefetch_state.cuh"

namespace {

constexpr int kProbeThreads = 256;

template <typename Id, bool kSorted>
__global__ void __launch_bounds__(kProbeThreads)
    probe_kernel(int C, int M, int K, rudder::IdIndex<Id> ix,
                 const uint8_t* __restrict__ active_probe,
                 const Id* __restrict__ queries, const Id* __restrict__ ids2,
                 const uint8_t* __restrict__ valid2,
                 const uint8_t* __restrict__ placed,
                 uint8_t* __restrict__ hit, int32_t* __restrict__ hit_slot,
                 uint8_t* __restrict__ acc3) {
  const int p = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int64_t j = (int64_t)p * M + m;
  const Id q = queries[j];
  int32_t slot = -1;
  if (active_probe[p] != 0 && q >= 0) {
    if constexpr (kSorted) {
      slot = rudder::sorted_lookup(ix, p, C, K, q, ids2, valid2, placed);
    } else {
      const int64_t d = ix.offset(q);
      if (d >= 0) slot = ix.slot_of[(int64_t)p * ix.span + d];
    }
    if (slot >= 0) acc3[(int64_t)p * C + slot] = 1;
  }
  hit[j] = slot >= 0;
  hit_slot[j] = slot;
}

template <typename Id, bool kSorted>
int launch(int P, int C, int M, int K, rudder::IdIndex<Id> ix, const Id* ids,
           const float* scores, const uint8_t* valid, const uint8_t* accessed,
           const uint8_t* in_cap, const float* weights, const Id* queries,
           const Id* cand, const float* cand_w, const uint8_t* active_score,
           const uint8_t* do_replace, const uint8_t* active_probe, Id* ids2,
           float* s2, uint8_t* valid2, uint8_t* acc3, float* w2, uint8_t* hit,
           int32_t* hit_slot, uint8_t* placed, int32_t* slot_pos,
           int32_t* n_placed, int32_t* n_valid, int32_t* rank_slot,
           const rudder::Policy& pol, cudaStream_t s) {
  if (P <= 0) return 0;
  const rudder::StateOut<uint8_t> out{placed, K, slot_pos, C, n_placed,
                                      n_valid, 1, nullptr, 0};
  cudaError_t err = rudder::launch_state<Id, kSorted>(
      P, C, K, rudder::SplitGates{active_score, do_replace, active_probe}, ix,
      ids, scores, valid, accessed, in_cap, weights, cand, cand_w,
      static_cast<const float*>(nullptr), ids2, s2, valid2, acc3, w2, out,
      rank_slot, pol, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M > 0) {
    dim3 grid((M + kProbeThreads - 1) / kProbeThreads, P);
    probe_kernel<Id, kSorted><<<grid, kProbeThreads, 0, s>>>(
        C, M, K, ix, active_probe, queries, ids2, valid2, placed, hit,
        hit_slot, acc3);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Launches (A) then (B) on `stream`. Pointers are device pointers of
// contiguous tensors; `weights`, `cand_w` and `w2` may be null (the
// unweighted policies; with weights, cand_w is required). Ids must lie in
// [0, N) or be negative padding; cand_first is filled with 0 and slot_of
// with -1 (prefetch_state.cuh). Returns the cudaError_t of the first
// failed launch, or 0.
extern "C" int rudder_fused_step(
    int P, int C, int M, int K, int N, const int32_t* ids, const float* scores,
    const uint8_t* valid, const uint8_t* accessed, const uint8_t* in_cap,
    const float* weights, const int32_t* queries, const int32_t* cand,
    const float* cand_w, const uint8_t* active_score, const uint8_t* do_replace,
    const uint8_t* active_probe, int32_t* ids2, float* s2, uint8_t* valid2,
    uint8_t* acc3, float* w2, uint8_t* hit, int32_t* hit_slot,
    uint8_t* placed, int32_t* slot_pos, int32_t* n_placed, int32_t* n_valid,
    int32_t* slot_of, int32_t* cand_first, int32_t* rank_slot, float increment,
    float decay, float threshold, float score_cap, float initial_score,
    int mode, void* stream) {
  const rudder::Policy pol{increment, decay, threshold, score_cap,
                           initial_score, mode};
  const rudder::IdIndex<int32_t> ix{0, N, slot_of, cand_first};
  return launch<int32_t, false>(
      P, C, M, K, ix, ids, scores, valid, accessed, in_cap, weights, queries,
      cand, cand_w, active_score, do_replace, active_probe, ids2, s2, valid2,
      acc3, w2, hit, hit_slot, placed, slot_pos, n_placed, n_valid, rank_slot,
      pol, static_cast<cudaStream_t>(stream));
}

// The int64 entry. `sorted` = 0: direct maps slot_of / cand_first over
// [lo, lo + span), every id in that range or negative padding; the sorted
// rows are null. `sorted` = 1: res_sorted / res_order (the resident ids,
// invalid slots as INT64_MAX, ascending, and their slots), cand_sorted /
// cand_order (the candidates stable-sorted, and their positions) and the
// (P, K) cand_slot scratch; the maps are null and ids may lie anywhere in
// [0, INT64_MAX).
extern "C" int rudder_fused_step_wide(
    int P, int C, int M, int K, int64_t lo, int64_t span, int sorted,
    const int64_t* ids, const float* scores, const uint8_t* valid,
    const uint8_t* accessed, const uint8_t* in_cap, const float* weights,
    const int64_t* queries, const int64_t* cand, const float* cand_w,
    const uint8_t* active_score, const uint8_t* do_replace,
    const uint8_t* active_probe, int64_t* ids2, float* s2, uint8_t* valid2,
    uint8_t* acc3, float* w2, uint8_t* hit, int32_t* hit_slot,
    uint8_t* placed, int32_t* slot_pos, int32_t* n_placed, int32_t* n_valid,
    int32_t* slot_of, int32_t* cand_first, int32_t* rank_slot,
    const int64_t* res_sorted, const int64_t* res_order,
    const int64_t* cand_sorted, const int64_t* cand_order, int32_t* cand_slot,
    float increment, float decay, float threshold, float score_cap,
    float initial_score, int mode, void* stream) {
  const rudder::Policy pol{increment, decay, threshold, score_cap,
                           initial_score, mode};
  const rudder::IdIndex<int64_t> ix{lo,          span,      slot_of,
                                    cand_first,  res_sorted, res_order,
                                    cand_sorted, cand_order, cand_slot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sorted) {
    return launch<int64_t, true>(
        P, C, M, K, ix, ids, scores, valid, accessed, in_cap, weights, queries,
        cand, cand_w, active_score, do_replace, active_probe, ids2, s2, valid2,
        acc3, w2, hit, hit_slot, placed, slot_pos, n_placed, n_valid,
        rank_slot, pol, s);
  }
  return launch<int64_t, false>(
      P, C, M, K, ix, ids, scores, valid, accessed, in_cap, weights, queries,
      cand, cand_w, active_score, do_replace, active_probe, ids2, s2, valid2,
      acc3, w2, hit, hit_slot, placed, slot_pos, n_placed, n_valid, rank_slot,
      pol, s);
}
