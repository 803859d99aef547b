// prefetch_state.cuh — the score → replace round over the (P, C) buffer
// state, shared by fused_frontier_step.cu and fused_step.cu (sm_90a).
//
// Spec: repro_torch/kernels/ref.py::fused_step_core, steps 1 and 2. One
// block per PE:
//   * the scoring round on valid slots of active_score PEs;
//   * free / stale slot fill ranks and fresh candidate ranks by block-wide
//     scans over contiguous per-thread chunks, so ranks follow slot and
//     candidate order;
//   * placement: the candidate of fresh rank r takes the slot of fill
//     rank r, at initial_score.
//
// Ids are a template parameter: int32_t on the narrow path, int64_t on the
// wide one (graphs whose global ids sit at an id_base or pass 2^31 - 2).
// Membership and first-occurrence dedup go through an IdIndex instead of
// the Pallas kernels' dense (K, C) / (K, K) comparison tiles, in one of
// two modes:
//   direct (kSorted = false): per-PE direct-mapped maps keyed by the
//     offset id - lo over [0, span):
//       slot_of[p][id - lo]    slot holding id (or -1), left updated for
//                              the probe that follows in the including file;
//       cand_first[p][id - lo] earliest candidate position holding id
//                              (atomicMin).
//     Both are (P, span) int32 scratch, filled by the wrapper (-1 and
//     INT_MAX). The narrow path is lo = 0, span = N: the maps, loads and
//     stores of the slice-1 kernel.
//   sorted (kSorted = true): for a launch whose span is past the wrapper's
//     memory budget for the maps. Per PE, the resident ids sorted once
//     (invalid slots as the sentinel, the largest Id, which no eligible id
//     reaches) with their slots, and the candidates stable-sorted with
//     their positions; membership is a binary search, and a candidate is
//     its id's first occurrence when the stable sort put it first among
//     the equal ids. Placement records each admitted candidate's slot in
//     cand_slot for the probe.
// Both modes rely on resident ids being unique per PE, which the
// replacement round guarantees (it only admits non-resident,
// first-occurrence ids).
//
// lo is also the origin of the local-indexed per-node arrays (part_of,
// node_weights): node_weights[id - lo]. On the frontier path lo is the
// graph's id_base in both modes.
//
// Scores are bit-exact with the plain version: every float operation is
// an explicit round-to-nearest intrinsic and the sources are built with
// -fmad=false, so no multiply-add is contracted into an FMA (a score that
// lands on the 0.95 stale threshold would otherwise flip a replacement).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rudder {

constexpr int kStateThreads = 1024;
constexpr int kModeAccumulate = 0;
constexpr int kModeReset = 1;
constexpr int kModeCapped = 2;

struct Policy {
  float increment;
  float decay;
  float threshold;
  float score_cap;
  float initial_score;
  int mode;
};

// Gate bits of PE p (active_score | do_replace << 1 | active_probe << 2)
// packed into the last column of a (P, stride) id block.
template <typename Id>
struct PackedGates {
  const Id* aug;
  int stride;
  __device__ __forceinline__ int operator()(int p) const {
    return static_cast<int>(aug[(int64_t)p * stride + (stride - 1)]);
  }
};

// The same bits from three (P,) bool vectors.
struct SplitGates {
  const uint8_t* score;
  const uint8_t* replace;
  const uint8_t* probe;
  __device__ __forceinline__ int operator()(int p) const {
    return (score[p] != 0) | ((replace[p] != 0) << 1) | ((probe[p] != 0) << 2);
  }
};

// Where a launch looks ids up (see the note at the top). Direct mode reads
// lo, span, slot_of and cand_first; sorted mode reads lo (for the per-node
// arrays) and the sorted rows. The unused pointers are null.
template <typename Id>
struct IdIndex {
  Id lo;
  int64_t span;
  int32_t* slot_of;           // (P, span)
  int32_t* cand_first;        // (P, span)
  const Id* res_sorted;       // (P, C) resident ids, ascending
  const int64_t* res_order;   // (P, C) their slots
  const Id* cand_sorted;      // (P, K) candidates, stable ascending
  const int64_t* cand_order;  // (P, K) their positions
  int32_t* cand_slot;         // (P, K) slot of each placed candidate

  // Offset of id in the direct maps, or -1 when it lies outside them
  // (padding included: every id >= 0 and lo >= 0).
  __device__ __forceinline__ int64_t offset(Id id) const {
    const int64_t d = static_cast<int64_t>(id) - static_cast<int64_t>(lo);
    return (id >= 0 && d >= 0 && d < span) ? d : -1;
  }
};

// First position in row[0, n) whose value is >= v.
template <typename Id>
__device__ __forceinline__ int lower_bound(const Id* row, int n, Id v) {
  int a = 0, b = n;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (row[m] < v) {
      a = m + 1;
    } else {
      b = m;
    }
  }
  return a;
}

// Slot of q in PE p's post-replace state, or -1 (sorted mode): q was
// resident before the round and its slot was not refilled, or q was
// admitted by this round.
template <typename Id>
__device__ __forceinline__ int32_t sorted_lookup(
    const IdIndex<Id>& ix, int p, int C, int K, Id q, const Id* ids2,
    const uint8_t* valid2, const uint8_t* placed) {
  const int64_t row_c = (int64_t)p * C;
  const int64_t row_k = (int64_t)p * K;
  int j = lower_bound(ix.res_sorted + row_c, C, q);
  if (j < C && ix.res_sorted[row_c + j] == q) {
    const int64_t c = ix.res_order[row_c + j];
    if (valid2[row_c + c] != 0 && ids2[row_c + c] == q) {
      return static_cast<int32_t>(c);
    }
  }
  j = lower_bound(ix.cand_sorted + row_k, K, q);
  if (j < K && ix.cand_sorted[row_k + j] == q) {
    const int64_t k = ix.cand_order[row_k + j];
    if (placed[row_k + k] != 0) return ix.cand_slot[row_k + k];
  }
  return -1;
}

// Exclusive block-wide scan of two counters at once; returns the totals.
// Every thread of the block must call it.
__device__ inline void block_scan2(int a, int b, int* excl_a, int* excl_b,
                                   int* tot_a, int* tot_b) {
  __shared__ int warp_a[32];
  __shared__ int warp_b[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int ia = a, ib = b;  // inclusive within the warp
  for (int off = 1; off < 32; off <<= 1) {
    int ya = __shfl_up_sync(0xffffffffu, ia, off);
    int yb = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) {
      ia += ya;
      ib += yb;
    }
  }
  if (lane == 31) {
    warp_a[warp] = ia;
    warp_b[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    int wa = lane < nwarps ? warp_a[lane] : 0;
    int wb = lane < nwarps ? warp_b[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      int ya = __shfl_up_sync(0xffffffffu, wa, off);
      int yb = __shfl_up_sync(0xffffffffu, wb, off);
      if (lane >= off) {
        wa += ya;
        wb += yb;
      }
    }
    warp_a[lane] = wa;  // inclusive prefix over warps
    warp_b[lane] = wb;
  }
  __syncthreads();
  const int before_a = warp > 0 ? warp_a[warp - 1] : 0;
  const int before_b = warp > 0 ? warp_b[warp - 1] : 0;
  *excl_a = before_a + ia - a;
  *excl_b = before_b + ib - b;
  *tot_a = warp_a[nwarps - 1];
  *tot_b = warp_b[nwarps - 1];
  __syncthreads();  // the shared arrays are reused by the next call
}

__device__ __forceinline__ float score_round(float s, bool accessed, float w,
                                             const Policy& pol) {
  if (!accessed) return __fmul_rn(s, pol.decay);
  const float gain = __fmul_rn(pol.increment, w);
  if (pol.mode == kModeReset) return __fadd_rn(gain, 0.0f);
  const float t = __fadd_rn(s, gain);
  return pol.mode == kModeCapped ? fminf(t, pol.score_cap) : t;
}

// One block per PE: score, rank, place. A placed slot's weight comes from
// cand_w[k] (per candidate) when given, else node_weights[id - lo], else
// 1.0.
template <typename Id, bool kSorted, class Gates>
__global__ void __launch_bounds__(kStateThreads)
    prefetch_state_kernel(int C, int K, Gates gates, IdIndex<Id> ix,
                          const Id* __restrict__ ids,
                          const float* __restrict__ scores,
                          const uint8_t* __restrict__ valid,
                          const uint8_t* __restrict__ accessed,
                          const uint8_t* __restrict__ in_cap,
                          const float* __restrict__ weights,
                          const Id* __restrict__ cand,
                          const float* __restrict__ cand_w,
                          const float* __restrict__ node_weights,
                          Id* __restrict__ ids2, float* __restrict__ s2,
                          uint8_t* __restrict__ valid2,
                          uint8_t* __restrict__ acc3, float* __restrict__ w2,
                          uint8_t* __restrict__ placed,
                          int32_t* __restrict__ slot_pos,
                          int32_t* __restrict__ rank_slot, Policy pol) {
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int g = gates(p);
  const bool active_score = (g & 1) != 0;
  const bool do_replace = (g & 2) != 0;

  const int64_t row_c = (int64_t)p * C;
  const int64_t row_k = (int64_t)p * K;
  const int64_t row_n = (int64_t)p * ix.span;
  int32_t* my_slot_of = kSorted ? nullptr : ix.slot_of + row_n;
  int32_t* my_cand_first = kSorted ? nullptr : ix.cand_first + row_n;

  // Contiguous chunks keep ranks in slot / candidate order.
  const int chunk_c = (C + T - 1) / T;
  const int c0 = min(t * chunk_c, C), c1 = min(c0 + chunk_c, C);
  const int chunk_k = (K + T - 1) / T;
  const int k0 = min(t * chunk_k, K), k1 = min(k0 + chunk_k, K);

  // -- score round; copy the state through; index the resident ids ----- //
  int n_free_mine = 0, n_stale_mine = 0;
  for (int c = c0; c < c1; ++c) {
    const int64_t i = row_c + c;
    const bool v = valid[i] != 0;
    const bool a = accessed[i] != 0;
    const float w = weights ? weights[i] : 1.0f;
    float s = scores[i];
    if (active_score && v) s = score_round(s, a, w, pol);
    const Id id = ids[i];
    s2[i] = s;
    ids2[i] = id;
    valid2[i] = v;
    acc3[i] = a && !active_score;
    if (weights) w2[i] = w;
    if constexpr (!kSorted) {
      const int64_t d = ix.offset(id);
      if (v && d >= 0) my_slot_of[d] = c;
    }
    n_free_mine += (!v && in_cap[i] != 0);
    n_stale_mine += (v && s < pol.threshold);
  }
  if constexpr (!kSorted) {
    for (int k = k0; k < k1; ++k) {
      const int64_t d = ix.offset(cand[row_k + k]);
      if (d >= 0) atomicMin(&my_cand_first[d], k);
    }
  }
  int free_before, stale_before, n_free, n_stale;
  block_scan2(n_free_mine, n_stale_mine, &free_before, &stale_before, &n_free,
              &n_stale);

  // -- fill ranks of free then stale slots ------------------------------ //
  const int big = C + K + 1;
  for (int c = c0; c < c1; ++c) {
    const int64_t i = row_c + c;
    const bool v = valid2[i] != 0;
    int r = big;
    if (!v && in_cap[i] != 0) {
      r = free_before++;
    } else if (v && s2[i] < pol.threshold) {
      r = n_free + stale_before++;
    }
    slot_pos[i] = r;
    if (r < big) rank_slot[row_c + r] = c;
  }

  // -- fresh candidates: valid, not resident, first occurrence --------- //
  // The flag is parked in `placed` so the placement pass below never
  // re-reads slot_of while other threads update it.
  int n_fresh_mine = 0;
  for (int k = k0; k < k1; ++k) {
    const Id id = cand[row_k + k];
    bool fresh = false;
    if (do_replace && id >= 0) {
      if constexpr (kSorted) {
        const int jr = lower_bound(ix.res_sorted + row_c, C, id);
        const bool resident = jr < C && ix.res_sorted[row_c + jr] == id;
        const int jc = lower_bound(ix.cand_sorted + row_k, K, id);
        fresh = !resident && ix.cand_order[row_k + jc] == k;
      } else {
        const int64_t d = ix.offset(id);
        fresh = d >= 0 && my_slot_of[d] < 0 && my_cand_first[d] == k;
      }
    }
    placed[row_k + k] = fresh;
    n_fresh_mine += fresh;
  }
  int fresh_before, unused_before, n_fresh, unused_total;
  block_scan2(n_fresh_mine, 0, &fresh_before, &unused_before, &n_fresh,
              &unused_total);
  const int n_place = do_replace ? min(n_free + n_stale, n_fresh) : 0;

  // -- placement: the candidate of fresh rank r takes the slot of fill
  //    rank r. New ids are never resident, so the slot_of entries cleared
  //    (replaced stale ids) and set (new ids) never coincide. ------------ //
  for (int k = k0; k < k1; ++k) {
    const int64_t j = row_k + k;
    bool is_placed = false;
    if (placed[j]) {
      const int r = fresh_before++;
      if (r < n_place) {
        is_placed = true;
        const int c = rank_slot[row_c + r];
        const int64_t i = row_c + c;
        const Id id = cand[j];
        if constexpr (kSorted) {
          ix.cand_slot[j] = c;
        } else {
          if (valid[i] != 0) {
            const int64_t d_old = ix.offset(ids[i]);
            if (d_old >= 0) my_slot_of[d_old] = -1;
          }
          my_slot_of[ix.offset(id)] = c;
        }
        ids2[i] = id;
        s2[i] = pol.initial_score;
        valid2[i] = 1;
        acc3[i] = 0;
        if (weights) {
          w2[i] = cand_w ? cand_w[j]
                         : (node_weights
                                ? node_weights[static_cast<int64_t>(id) -
                                               static_cast<int64_t>(ix.lo)]
                                : 1.0f);
        }
      }
    }
    placed[j] = is_placed;
  }
}

}  // namespace rudder
