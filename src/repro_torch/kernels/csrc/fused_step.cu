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
// What bounds it on this card: bytes, and below them latency. The launch
// reads the (P, C) state, the (P, M) queries and the (P, K) candidates and
// writes the state, hit / hit_slot, placed and slot_pos; at P = 4, C ~ 23k,
// M ~ K ~ 22k that is a few MB, one to two microseconds at 3.35 TB/s. The
// work is a chain of dependent passes (score, rank, fresh test, placement,
// probe), each a handful of integer operations an element, so the time is
// the passes' latency on the SMs the launch occupies.
//
// What the design does about it: one launch and no memset. One kernel,
// fused_step_kernel, one thread-block cluster of kStepBlocks blocks per PE:
//   (1) the state round of prefetch_state.cuh (score, rank, place; each
//       block a slice of the slots and candidates, kStepItems elements a
//       thread in flight at once, one block scan a pass);
//   (2) after a cluster barrier, the probe of the PE's M queries by the
//       cluster's blocks: hit, hit_slot (-1 on a miss) and accessed marks
//       for hit slots (several threads may write the same 1 to a slot: a
//       benign race);
//   (3) after another cluster barrier, in the direct mode, the restore:
//       slot_of[id - lo] = -1 for every valid id of the new state and
//       cand_first[id - lo] = 0 for every candidate. Those are the only
//       entries the launch wrote (placement already put back the entries
//       of the ids it evicted), so the (P, span) maps are clean again for
//       the next launch: the wrapper keeps them from one launch to the next
//       and fills them once, when it allocates them.
// The IdIndex of prefetch_state.cuh answers membership, first occurrence
// and the probe with one load each (direct maps keyed by id - lo) or a
// binary search (sorted mode, for a launch whose id span is past the
// wrapper's memory budget for the maps; no restore there).
//
// Two output forms, the same kernel: the reference's eleven outputs as
// separate tensors (rudder_fused_step, rudder_fused_step_wide; gates as
// three bool vectors), and the engine's (rudder_fused_step_packed,
// rudder_fused_step_wide_packed; gates as the (P,) int32 words the engine
// uploads), where the round and the probe write hit, hit_slot, placed,
// slot_pos and n_valid straight into the columns of the packed readback
// [hit | hit_slot | placed | slot_pos | n_valid] (P, 2 M + K + C + 1).
// Two id widths: int32 (ids in [0, N), lo = 0) and int64 at any lo, the
// port of fused_step_wide_pallas (src/repro/kernels/fused_step.py:445),
// whose (hi, lo) word planes int64 replaces.
// Bit-exact scores: see prefetch_state.cuh (-fmad=false, _rn intrinsics).

#include <cuda_runtime.h>
#include <stdint.h>

#include "prefetch_state.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int T = rudder::kStateThreads;
// Blocks per PE (the cluster; 16 is a non-portable size) and elements a
// thread takes per tile: 16 x 4 against 8 x 8, 8 x 4 and 8 x 1 is the
// fastest at the ragged loop's shape (scripts/fused_step_ab.py).
constexpr int kStepBlocks = 16;
constexpr int kStepItems = 4;

// Where the probe writes: hit (0/1 as OutT) and hit_slot rows at `stride`.
template <typename OutT>
struct ProbeOut {
  OutT* hit;
  int32_t* hit_slot;
  int64_t stride;
};

// Grid (kStepBlocks, P), one cluster per PE: the round, the probe, the
// restore (see the note at the top).
template <typename Id, bool kSorted, class Gates, typename OutT>
__global__ void __cluster_dims__(kStepBlocks, 1, 1) __launch_bounds__(T)
    fused_step_kernel(int C, int M, int K, Gates gates, rudder::IdIndex<Id> ix,
                      const Id* __restrict__ ids,
                      const float* __restrict__ scores,
                      const uint8_t* __restrict__ valid,
                      const uint8_t* __restrict__ accessed,
                      const uint8_t* __restrict__ in_cap,
                      const float* __restrict__ weights,
                      const Id* __restrict__ queries,
                      const Id* __restrict__ cand,
                      const float* __restrict__ cand_w, Id* __restrict__ ids2,
                      float* __restrict__ s2, uint8_t* __restrict__ valid2,
                      uint8_t* __restrict__ acc3, float* __restrict__ w2,
                      rudder::StateOut<OutT> out, ProbeOut<OutT> probe,
                      int32_t* __restrict__ rank_slot, rudder::Policy pol) {
  const cg::cluster_group cluster = cg::this_cluster();
  rudder::state_round<kStepBlocks, kStepItems, Id, kSorted>(
      cluster, C, K, gates, ix, ids, scores, valid, accessed, in_cap, weights,
      cand, cand_w, static_cast<const float*>(nullptr), ids2, s2, valid2, acc3,
      w2, out, rank_slot, pol);
  __threadfence();
  cluster.sync();  // the new state, placed and slot_of, cluster-wide

  const int b = static_cast<int>(cluster.block_rank());
  const int p = blockIdx.y;
  const int t = threadIdx.x;
  const int64_t row_c = (int64_t)p * C;
  const int64_t row_k = (int64_t)p * K;

  // -- (2) probe: element j of thread t of block b at tile position
  //    (j * kStepBlocks + b) * T + t, so that the blocks share each tile. - //
  const bool active_probe = (gates(p) & 4) != 0;
  const OutT* placed_row = out.placed + (int64_t)p * out.placed_stride;
  const int32_t* my_slot_of = kSorted ? nullptr : ix.slot_of + (int64_t)p * ix.span;
  for (int base = 0; base < M; base += kStepBlocks * T * kStepItems) {
    Id q[kStepItems];
#pragma unroll
    for (int j = 0; j < kStepItems; ++j) {
      const int m = base + (j * kStepBlocks + b) * T + t;
      q[j] = m < M ? queries[(int64_t)p * M + m] : Id(-1);
    }
    int32_t slot[kStepItems];
#pragma unroll
    for (int j = 0; j < kStepItems; ++j) {
      slot[j] = -1;
      if (active_probe && q[j] >= 0) {
        if constexpr (kSorted) {
          slot[j] = rudder::sorted_lookup(ix, p, C, K, q[j], ids2, valid2,
                                          placed_row);
        } else {
          const int64_t d = ix.offset(q[j]);
          if (d >= 0) slot[j] = my_slot_of[d];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kStepItems; ++j) {
      const int m = base + (j * kStepBlocks + b) * T + t;
      if (m < M) {
        if (slot[j] >= 0) acc3[row_c + slot[j]] = 1;
        probe.hit[(int64_t)p * probe.stride + m] = static_cast<OutT>(slot[j] >= 0);
        probe.hit_slot[(int64_t)p * probe.stride + m] = slot[j];
      }
    }
  }
  if constexpr (!kSorted) {
    // -- (3) restore: every map entry this launch wrote, back to -1 / 0 - //
    __threadfence();
    cluster.sync();  // every block's probe has read slot_of
    int32_t* my_map = ix.slot_of + (int64_t)p * ix.span;
    int32_t* my_first = ix.cand_first + (int64_t)p * ix.span;
    const int c_span = (C + kStepBlocks - 1) / kStepBlocks;
    const int c_lo = min(b * c_span, C), c_hi = min(c_lo + c_span, C);
    const int k_span = (K + kStepBlocks - 1) / kStepBlocks;
    const int k_lo = min(b * k_span, K), k_hi = min(k_lo + k_span, K);
    for (int base = c_lo; base < c_hi; base += T * kStepItems) {
      int64_t d[kStepItems];
#pragma unroll
      for (int j = 0; j < kStepItems; ++j) {
        const int c = base + j * T + t;
        d[j] = c < c_hi && valid2[row_c + c] != 0 ? ix.offset(ids2[row_c + c])
                                                  : -1;
      }
#pragma unroll
      for (int j = 0; j < kStepItems; ++j) {
        if (d[j] >= 0) my_map[d[j]] = -1;
      }
    }
    for (int base = k_lo; base < k_hi; base += T * kStepItems) {
      int64_t d[kStepItems];
#pragma unroll
      for (int j = 0; j < kStepItems; ++j) {
        const int k = base + j * T + t;
        d[j] = k < k_hi ? ix.offset(cand[row_k + k]) : -1;
      }
#pragma unroll
      for (int j = 0; j < kStepItems; ++j) {
        if (d[j] >= 0) my_first[d[j]] = 0;
      }
    }
  }
}

// Launches fused_step_kernel on `s`: grid (kStepBlocks, P), one cluster a
// PE.
template <typename Id, bool kSorted, class Gates, typename OutT>
int launch(int P, int C, int M, int K, Gates gates,
           const rudder::IdIndex<Id>& ix, const Id* ids, const float* scores,
           const uint8_t* valid, const uint8_t* accessed,
           const uint8_t* in_cap, const float* weights, const Id* queries,
           const Id* cand, const float* cand_w, Id* ids2, float* s2,
           uint8_t* valid2, uint8_t* acc3, float* w2,
           const rudder::StateOut<OutT>& out, const ProbeOut<OutT>& probe,
           int32_t* rank_slot, const rudder::Policy& pol, cudaStream_t s) {
  if (P <= 0) return 0;
  if (kStepBlocks > 8) {  // a non-portable cluster size, allowed once
    static const cudaError_t allowed = cudaFuncSetAttribute(
        fused_step_kernel<Id, kSorted, Gates, OutT>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
  }
  fused_step_kernel<Id, kSorted, Gates, OutT><<<dim3(kStepBlocks, P), T, 0, s>>>(
      C, M, K, gates, ix, ids, scores, valid, accessed, in_cap, weights, queries,
      cand, cand_w, ids2, s2, valid2, acc3, w2, out, probe, rank_slot, pol);
  return static_cast<int>(cudaGetLastError());
}

// The separate outputs of the reference's form.
struct Separate {
  rudder::StateOut<uint8_t> out;
  ProbeOut<uint8_t> probe;
  Separate(int C, int M, int K, uint8_t* hit, int32_t* hit_slot,
           uint8_t* placed, int32_t* slot_pos, int32_t* n_placed,
           int32_t* n_valid)
      : out{placed, K, slot_pos, C, n_placed, n_valid, 1, nullptr, 0,
            nullptr, 0, nullptr},
        probe{hit, hit_slot, M} {}
};

// The columns of the packed readback (P, W), W = 2 M + K + C + 1.
struct Packed {
  rudder::StateOut<int32_t> out;
  ProbeOut<int32_t> probe;
  Packed(int C, int M, int K, int32_t* packed)
      : out{packed + 2 * M,
            2 * M + K + C + 1,
            packed + 2 * M + K,
            2 * M + K + C + 1,
            nullptr,
            packed + 2 * M + K + C,
            2 * M + K + C + 1,
            nullptr,
            0,
            nullptr,
            0,
            nullptr},
        probe{packed, packed + M, 2 * M + K + C + 1} {}
};

}  // namespace

// The reference's form, int32 ids. Pointers are device pointers of
// contiguous tensors; `weights`, `cand_w` and `w2` may be null (the
// unweighted policies; with weights, cand_w is required). Ids must lie in
// [0, N) or be negative padding. slot_of and cand_first are (P, N) int32
// maps at -1 and 0, left so; rank_slot (P, C) is scratch. Returns the
// cudaError_t of the launch, or 0.
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
  const Separate o(C, M, K, hit, hit_slot, placed, slot_pos, n_placed,
                            n_valid);
  return launch<int32_t, false>(
      P, C, M, K, rudder::SplitGates{active_score, do_replace, active_probe},
      ix, ids, scores, valid, accessed, in_cap, weights, queries, cand, cand_w,
      ids2, s2, valid2, acc3, w2, o.out, o.probe, rank_slot, pol,
      static_cast<cudaStream_t>(stream));
}

// The engine's form, int32 ids: the gate words (P,) and the packed
// readback (P, 2 M + K + C + 1) in place of the gate vectors and the five
// host-facing outputs; otherwise as rudder_fused_step.
extern "C" int rudder_fused_step_packed(
    int P, int C, int M, int K, int N, const int32_t* ids, const float* scores,
    const uint8_t* valid, const uint8_t* accessed, const uint8_t* in_cap,
    const float* weights, const int32_t* queries, const int32_t* cand,
    const float* cand_w, const int32_t* gates, int32_t* ids2, float* s2,
    uint8_t* valid2, uint8_t* acc3, float* w2, int32_t* packed,
    int32_t* slot_of, int32_t* cand_first, int32_t* rank_slot, float increment,
    float decay, float threshold, float score_cap, float initial_score,
    int mode, void* stream) {
  const rudder::Policy pol{increment, decay, threshold, score_cap,
                           initial_score, mode};
  const rudder::IdIndex<int32_t> ix{0, N, slot_of, cand_first};
  const Packed o(C, M, K, packed);
  return launch<int32_t, false>(
      P, C, M, K, rudder::PackedGates<int32_t>{gates, 1}, ix, ids, scores,
      valid, accessed, in_cap, weights, queries, cand, cand_w, ids2, s2,
      valid2, acc3, w2, o.out, o.probe, rank_slot, pol,
      static_cast<cudaStream_t>(stream));
}

namespace {

// The wide entries' index, and their launch in either mode.
template <class Gates, typename OutT>
int launch_wide(int P, int C, int M, int K, int64_t lo, int64_t span,
                int sorted, Gates gates, const int64_t* ids,
                const float* scores, const uint8_t* valid,
                const uint8_t* accessed, const uint8_t* in_cap,
                const float* weights, const int64_t* queries,
                const int64_t* cand, const float* cand_w, int64_t* ids2,
                float* s2, uint8_t* valid2, uint8_t* acc3, float* w2,
                const rudder::StateOut<OutT>& out, const ProbeOut<OutT>& probe,
                int32_t* slot_of, int32_t* cand_first, int32_t* rank_slot,
                const int64_t* res_sorted, const int64_t* res_order,
                const int64_t* cand_sorted, const int64_t* cand_order,
                int32_t* cand_slot, const rudder::Policy& pol, void* stream) {
  const rudder::IdIndex<int64_t> ix{lo,          span,      slot_of,
                                    cand_first,  res_sorted, res_order,
                                    cand_sorted, cand_order, cand_slot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sorted) {
    return launch<int64_t, true>(P, C, M, K, gates, ix, ids, scores, valid,
                                 accessed, in_cap, weights, queries, cand,
                                 cand_w, ids2, s2, valid2, acc3, w2, out,
                                 probe, rank_slot, pol, s);
  }
  return launch<int64_t, false>(P, C, M, K, gates, ix, ids, scores, valid,
                                accessed, in_cap, weights, queries, cand,
                                cand_w, ids2, s2, valid2, acc3, w2, out, probe,
                                rank_slot, pol, s);
}

}  // namespace

// The reference's form, int64 ids. `sorted` = 0: direct maps slot_of /
// cand_first over [lo, lo + span), at -1 and 0 and left so, every id in
// that range or negative padding; the sorted rows are null. `sorted` = 1:
// res_sorted / res_order (the resident ids, invalid slots as INT64_MAX,
// ascending, and their slots), cand_sorted / cand_order (the candidates
// stable-sorted, and their positions) and the (P, K) cand_slot scratch;
// the maps are null and ids may lie anywhere in [0, INT64_MAX).
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
  const Separate o(C, M, K, hit, hit_slot, placed, slot_pos, n_placed,
                            n_valid);
  return launch_wide(
      P, C, M, K, lo, span, sorted,
      rudder::SplitGates{active_score, do_replace, active_probe}, ids, scores,
      valid, accessed, in_cap, weights, queries, cand, cand_w, ids2, s2,
      valid2, acc3, w2, o.out, o.probe, slot_of, cand_first, rank_slot,
      res_sorted, res_order, cand_sorted, cand_order, cand_slot, pol, stream);
}

// The engine's form, int64 ids: as rudder_fused_step_wide with the gate
// words and the packed readback of rudder_fused_step_packed.
extern "C" int rudder_fused_step_wide_packed(
    int P, int C, int M, int K, int64_t lo, int64_t span, int sorted,
    const int64_t* ids, const float* scores, const uint8_t* valid,
    const uint8_t* accessed, const uint8_t* in_cap, const float* weights,
    const int64_t* queries, const int64_t* cand, const float* cand_w,
    const int32_t* gates, int64_t* ids2, float* s2, uint8_t* valid2,
    uint8_t* acc3, float* w2, int32_t* packed, int32_t* slot_of,
    int32_t* cand_first, int32_t* rank_slot, const int64_t* res_sorted,
    const int64_t* res_order, const int64_t* cand_sorted,
    const int64_t* cand_order, int32_t* cand_slot, float increment,
    float decay, float threshold, float score_cap, float initial_score,
    int mode, void* stream) {
  const rudder::Policy pol{increment, decay, threshold, score_cap,
                           initial_score, mode};
  const Packed o(C, M, K, packed);
  return launch_wide(
      P, C, M, K, lo, span, sorted, rudder::PackedGates<int32_t>{gates, 1},
      ids, scores, valid, accessed, in_cap, weights, queries, cand, cand_w,
      ids2, s2, valid2, acc3, w2, o.out, o.probe, slot_of, cand_first,
      rank_slot, res_sorted, res_order, cand_sorted, cand_order, cand_slot,
      pol, stream);
}
