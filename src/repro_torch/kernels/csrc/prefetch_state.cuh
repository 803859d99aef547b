// prefetch_state.cuh — the score → replace round over the (P, C) buffer
// state, shared by fused_frontier_step.cu and fused_step.cu (sm_90a).
//
// Spec: repro_torch/kernels/ref.py::fused_step_core, steps 1 and 2. One
// thread-block cluster of kBlocks blocks per PE (state_round, a device
// function the including file's kernel calls); each block owns a
// contiguous 1/kBlocks of the PE's slots and of its candidates and walks
// it in tiles of kStateThreads x kItems elements, element j of thread t at
// tile position j * kStateThreads + t (neighbouring threads on
// neighbouring addresses, so every load coalesces, and a thread's kItems
// loads are independent, so they are in flight together):
//   * the scoring round on valid slots of active_score PEs;
//   * free / stale slot fill ranks and fresh candidate ranks by one block
//     scan per tile (block_scan_n: the kItems rows of the tile scanned
//     together) plus a carry, after the counts of the lower blocks of the
//     cluster (read from their shared memory, DSMEM), so ranks follow
//     slot and candidate order as in the plain version;
//   * placement: the candidate of fresh rank r takes the slot of fill
//     rank r, at initial_score.
// When a block's slots (candidates) fit one tile — up to 32,768 a PE for
// both steps' shapes, so every launch of the trainers' paths — the free /
// stale flags (the candidates and their fresh flags) stay in registers
// from one pass to the next; otherwise each pass re-reads them. Two cluster barriers order the
// passes: the first makes every slot's index entry and every candidate's
// first-occurrence entry visible before the fresh test, the second makes
// every fresh flag and fill rank visible before placement (which rewrites
// slot_of). The caller ends the round with a third (cluster.sync), which
// keeps each block's shared counts alive until the others have read them;
// fused_step.cu's kernel fences first and probes after it.
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
//       cand_first[p][id - lo] INT_MAX - (earliest candidate position
//                              holding id), by atomicMax, so that a zero
//                              entry is an empty one.
//     Both are (P, span) int32 scratch at -1 and 0 when the launch starts:
//     the frontier step memsets them, the fused step keeps them clean from
//     one launch to the next (its kernel puts back what it wrote). The
//     narrow path is lo = 0, span = N.
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
// Where the round writes placed, slot_pos and the per-PE counts n_place
// and n_valid is the caller's (StateOut): separate tensors, or the columns
// of the packed readback (and the counters of the frontier step), so that
// no epilogue copies them.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rudder {

namespace cg = cooperative_groups;

constexpr int kStateThreads = 512;
// The frontier step's cluster: blocks per PE.
constexpr int kStateCluster = 8;
// Elements a thread takes per tile of the state round (see the note at
// the top); the fused step's kernel picks its own (fused_step.cu).
constexpr int kStateItems = 8;
constexpr int kModeAccumulate = 0;
constexpr int kModeReset = 1;
constexpr int kModeCapped = 2;
constexpr int32_t kInt32Max = 2147483647;

struct Policy {
  float increment;
  float decay;
  float threshold;
  float score_cap;
  float initial_score;
  int mode;
};

// Gate bits of PE p (active_score | do_replace << 1 | active_probe << 2)
// in column stride - 1 of a (P, stride) block of Ids: the last column of
// the frontier step's id block, or (stride 1) the (P,) int32 words the
// fused step's engine uploads.
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

// The round's per-PE outputs besides the state: placed (0/1 as PlacedT)
// and slot_pos rows at their row strides, n_place and n_valid at
// count_stride (n_place may be null), and optionally n_valid once more at
// n_valid_col (the packed readback's last column). Optionally too, for the
// kernels that run after the round: rows of fill_words 32-bit words at
// fill_ones set to all ones, and the first two words of every 4-word row
// at clear_counters set to 0. The optional pointers are null when unused.
template <typename PlacedT>
struct StateOut {
  PlacedT* placed;
  int64_t placed_stride;
  int32_t* slot_pos;
  int64_t slot_pos_stride;
  int32_t* n_place;
  int32_t* n_valid;
  int64_t count_stride;
  int32_t* n_valid_col;
  int64_t n_valid_col_stride;
  uint32_t* fill_ones;
  int64_t fill_words;
  int32_t* clear_counters;
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
// admitted by this round. placed_row is PE p's row of the placed flags.
template <typename Id, typename PlacedT>
__device__ __forceinline__ int32_t sorted_lookup(
    const IdIndex<Id>& ix, int p, int C, int K, Id q, const Id* ids2,
    const uint8_t* valid2, const PlacedT* placed_row) {
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
    if (placed_row[k] != 0) return ix.cand_slot[row_k + k];
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

// N exclusive block-wide scans at once, one per counter of v (over the
// threads in order); tot gets the block totals. Three __syncthreads for
// all N. Every thread of the block must call it.
template <int N>
__device__ __forceinline__ void block_scan_n(const uint32_t (&v)[N],
                                             uint32_t (&excl)[N],
                                             uint32_t (&tot)[N]) {
  __shared__ uint32_t warp_sums[N][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  uint32_t inc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) inc[j] = v[j];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, inc[j], off);
      if (lane >= off) inc[j] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < N; ++j) warp_sums[j][warp] = inc[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint32_t w = lane < nwarps ? warp_sums[j][lane] : 0u;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[j][lane] = w;  // inclusive prefix over warps
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    excl[j] = (warp > 0 ? warp_sums[j][warp - 1] : 0u) + inc[j] - v[j];
    tot[j] = warp_sums[j][nwarps - 1];
  }
  __syncthreads();  // the shared array is reused by the next call
}

// Sums of words [first, first + N) of `counts` over the cluster's kBlocks
// blocks (total) and over those of rank below b (below). Lane r < kBlocks
// of each warp reads block r's words, so that a warp makes one round trip
// to distributed shared memory, and the warp adds them up.
template <int kBlocks, int N>
__device__ __forceinline__ void cluster_sums(const cg::cluster_group& cluster,
                                             int* counts, int first, int b,
                                             int (&total)[N], int (&below)[N]) {
  static_assert(kBlocks <= 32, "one lane a block");
  const int lane = threadIdx.x & 31;
  int mine[N];
#pragma unroll
  for (int i = 0; i < N; ++i) mine[i] = 0;
  if (lane < kBlocks) {
    const int* theirs = cluster.map_shared_rank(counts, lane);
#pragma unroll
    for (int i = 0; i < N; ++i) mine[i] = theirs[first + i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    total[i] = mine[i];
    below[i] = lane < b ? mine[i] : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      total[i] += __shfl_xor_sync(0xffffffffu, total[i], off);
      below[i] += __shfl_xor_sync(0xffffffffu, below[i], off);
    }
  }
}

__device__ __forceinline__ float score_round(float s, bool accessed, float w,
                                             const Policy& pol) {
  if (!accessed) return __fmul_rn(s, pol.decay);
  const float gain = __fmul_rn(pol.increment, w);
  if (pol.mode == kModeReset) return __fadd_rn(gain, 0.0f);
  const float t = __fadd_rn(s, gain);
  return pol.mode == kModeCapped ? fminf(t, pol.score_cap) : t;
}

// The round of PE blockIdx.y by this block, rank cluster.block_rank() of
// the kBlocks blocks of its cluster: score, rank, place. A placed slot's
// weight comes from cand_w[k] (per candidate) when given, else
// node_weights[id - lo], else 1.0. Every thread of the cluster must call
// it; the caller ends it with cluster.sync() (see the note at the top).
template <int kBlocks, int kItems, typename Id, bool kSorted, class Gates,
          typename PlacedT>
__device__ __forceinline__ void state_round(
    const cg::cluster_group& cluster, int C, int K, const Gates& gates,
    const IdIndex<Id>& ix, const Id* __restrict__ ids,
    const float* __restrict__ scores, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ accessed, const uint8_t* __restrict__ in_cap,
    const float* __restrict__ weights, const Id* __restrict__ cand,
    const float* __restrict__ cand_w, const float* __restrict__ node_weights,
    Id* __restrict__ ids2, float* __restrict__ s2,
    uint8_t* __restrict__ valid2, uint8_t* __restrict__ acc3,
    float* __restrict__ w2, const StateOut<PlacedT>& out,
    int32_t* __restrict__ rank_slot, const Policy& pol) {
  constexpr int T = kStateThreads;
  constexpr int kTile = T * kItems;
  // This block's counts, read by the whole cluster: free, stale and valid
  // slots, fresh candidates.
  __shared__ int counts[4];
  const int b = static_cast<int>(cluster.block_rank());
  const int p = blockIdx.y;
  const int t = threadIdx.x;
  const int g = gates(p);
  const bool active_score = (g & 1) != 0;
  const bool do_replace = (g & 2) != 0;

  const int64_t row_c = (int64_t)p * C;
  const int64_t row_k = (int64_t)p * K;
  const int64_t row_n = (int64_t)p * ix.span;
  int32_t* my_slot_of = kSorted ? nullptr : ix.slot_of + row_n;
  int32_t* my_cand_first = kSorted ? nullptr : ix.cand_first + row_n;
  PlacedT* my_placed = out.placed + (int64_t)p * out.placed_stride;
  int32_t* my_slot_pos = out.slot_pos + (int64_t)p * out.slot_pos_stride;

  if (out.fill_ones) {
    uint32_t* row = out.fill_ones + (int64_t)p * out.fill_words;
    for (int64_t j = (int64_t)b * T + t; j < out.fill_words; j += kBlocks * T) {
      row[j] = 0xFFFFFFFFu;
    }
  }
  if (out.clear_counters && b == 0 && t == 0) {
    out.clear_counters[4 * p] = 0;
    out.clear_counters[4 * p + 1] = 0;
  }

  const int c_span = (C + kBlocks - 1) / kBlocks;
  const int c_lo = min(b * c_span, C), c_hi = min(c_lo + c_span, C);
  const int k_span = (K + kBlocks - 1) / kBlocks;
  const int k_lo = min(b * k_span, K), k_hi = min(k_lo + k_span, K);
  // One tile holds the whole slice: flags and candidates stay in registers.
  const bool c_one = c_hi - c_lo <= kTile;
  const bool k_one = k_hi - k_lo <= kTile;

  // -- score round; copy the state through; index the resident ids ----- //
  // fl: free | stale << 16 of this thread's slots of the last tile.
  uint32_t fl[kItems] = {};
  uint32_t n_mine[3] = {0u, 0u, 0u};  // free, stale, valid
  for (int base = c_lo; base < c_hi; base += kTile) {
    bool v[kItems], a[kItems], cap[kItems];
    float s[kItems], w[kItems];
    Id id[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int c = base + j * T + t;
      if (c < c_hi) {
        const int64_t i = row_c + c;
        v[j] = valid[i] != 0;
        a[j] = accessed[i] != 0;
        cap[j] = in_cap[i] != 0;
        s[j] = scores[i];
        w[j] = weights ? weights[i] : 1.0f;
        id[j] = ids[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int c = base + j * T + t;
      fl[j] = 0u;
      if (c < c_hi) {
        const int64_t i = row_c + c;
        float sc = s[j];
        if (active_score && v[j]) sc = score_round(sc, a[j], w[j], pol);
        s2[i] = sc;
        ids2[i] = id[j];
        valid2[i] = v[j];
        acc3[i] = a[j] && !active_score;
        if (weights) w2[i] = w[j];
        if constexpr (!kSorted) {
          const int64_t d = ix.offset(id[j]);
          if (v[j] && d >= 0) my_slot_of[d] = c;
        }
        const uint32_t is_free = !v[j] && cap[j];
        const uint32_t is_stale = v[j] && sc < pol.threshold;
        fl[j] = is_free | (is_stale << 16);
        n_mine[0] += is_free;
        n_mine[1] += is_stale;
        n_mine[2] += v[j];
      }
    }
  }
  // cid: this thread's candidates of the last tile (-1 past the slice).
  Id cid[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) cid[j] = Id(-1);
  if constexpr (!kSorted) {
    for (int base = k_lo; base < k_hi; base += kTile) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int k = base + j * T + t;
        cid[j] = k < k_hi ? cand[row_k + k] : Id(-1);
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int64_t d = ix.offset(cid[j]);
        if (d >= 0) atomicMax(&my_cand_first[d], kInt32Max - (base + j * T + t));
      }
    }
  }
  uint32_t unused[3], tot[3];
  block_scan_n<3>(n_mine, unused, tot);
  if (t == 0) {
    counts[0] = static_cast<int>(tot[0]);
    counts[1] = static_cast<int>(tot[1]);
    counts[2] = static_cast<int>(tot[2]);
  }
  __threadfence();
  cluster.sync();

  int totals[3], lower[3];  // free, stale, valid
  cluster_sums<kBlocks, 3>(cluster, counts, 0, b, totals, lower);
  const int n_free = totals[0], n_stale = totals[1], n_valid = totals[2];
  int free_before = lower[0], stale_before = lower[1];

  // -- fill ranks of free then stale slots, in slot order --------------- //
  // A tile holds at most kTile flags of each kind, so the free and stale
  // counts of a scan share one word. A thread re-reads (for a slice of
  // several tiles) only the slots it wrote above.
  const int big = C + K + 1;
  for (int base = c_lo; base < c_hi; base += kTile) {
    if (!c_one) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int c = base + j * T + t;
        fl[j] = 0u;
        if (c < c_hi) {
          const int64_t i = row_c + c;
          const bool v = valid2[i] != 0;
          fl[j] = static_cast<uint32_t>(!v && in_cap[i] != 0) |
                  (static_cast<uint32_t>(v && s2[i] < pol.threshold) << 16);
        }
      }
    }
    uint32_t ex[kItems], rows[kItems];
    block_scan_n<kItems>(fl, ex, rows);
    uint32_t before = 0u;  // free | stale << 16 of the tile's lower rows
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int c = base + j * T + t;
      if (c < c_hi) {
        const uint32_t e = before + ex[j];
        int r = big;
        if (fl[j] & 0xFFFFu) {
          r = free_before + static_cast<int>(e & 0xFFFFu);
        } else if (fl[j] >> 16) {
          r = n_free + stale_before + static_cast<int>(e >> 16);
        }
        my_slot_pos[c] = r;
        if (r < big) rank_slot[row_c + r] = c;
      }
      before += rows[j];
    }
    free_before += static_cast<int>(before & 0xFFFFu);
    stale_before += static_cast<int>(before >> 16);
  }

  // -- fresh candidates: valid, not resident, first occurrence --------- //
  // For a slice of several tiles the flag is parked in `placed`, so that
  // the placement pass never re-reads slot_of while other threads update
  // it.
  uint32_t fr[kItems];
  uint32_t n_fresh_mine[1] = {0u};
  for (int base = k_lo; base < k_hi; base += kTile) {
    if (kSorted || !k_one) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int k = base + j * T + t;
        cid[j] = k < k_hi ? cand[row_k + k] : Id(-1);
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int k = base + j * T + t;
      const Id id = cid[j];
      bool fresh = false;
      if (do_replace && id >= 0) {
        if constexpr (kSorted) {
          const int jr = lower_bound(ix.res_sorted + row_c, C, id);
          const bool resident = jr < C && ix.res_sorted[row_c + jr] == id;
          const int jc = lower_bound(ix.cand_sorted + row_k, K, id);
          fresh = !resident && ix.cand_order[row_k + jc] == k;
        } else {
          const int64_t d = ix.offset(id);
          fresh = d >= 0 && my_slot_of[d] < 0 &&
                  my_cand_first[d] == kInt32Max - k;
        }
      }
      fr[j] = fresh;
      if (!k_one && k < k_hi) my_placed[k] = static_cast<PlacedT>(fresh);
      n_fresh_mine[0] += fresh;
    }
  }
  uint32_t tot_fresh[1], unused1[1];
  block_scan_n<1>(n_fresh_mine, unused1, tot_fresh);
  if (t == 0) counts[3] = static_cast<int>(tot_fresh[0]);
  __threadfence();
  cluster.sync();

  int fresh_total[1], fresh_lower[1];
  cluster_sums<kBlocks, 1>(cluster, counts, 3, b, fresh_total, fresh_lower);
  const int n_fresh = fresh_total[0];
  int fresh_before = fresh_lower[0];
  const int n_place = do_replace ? min(n_free + n_stale, n_fresh) : 0;

  // -- placement: the candidate of fresh rank r takes the slot of fill
  //    rank r. New ids are never resident, so the slot_of entries cleared
  //    (replaced stale ids) and set (new ids) never coincide. ------------ //
  for (int base = k_lo; base < k_hi; base += kTile) {
    if (!k_one) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int k = base + j * T + t;
        fr[j] = k < k_hi && my_placed[k] != 0;
        cid[j] = k < k_hi ? cand[row_k + k] : Id(-1);
      }
    }
    uint32_t ex[kItems], rows[kItems];
    block_scan_n<kItems>(fr, ex, rows);
    int before = fresh_before;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int k = base + j * T + t;
      if (k < k_hi) {
        const int r = before + static_cast<int>(ex[j]);
        const bool is_placed = fr[j] != 0 && r < n_place;
        if (is_placed) {
          const int64_t jj = row_k + k;
          const int c = rank_slot[row_c + r];
          const int64_t i = row_c + c;
          const Id id = cid[j];
          if constexpr (kSorted) {
            ix.cand_slot[jj] = c;
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
            w2[i] = cand_w ? cand_w[jj]
                           : (node_weights
                                  ? node_weights[static_cast<int64_t>(id) -
                                                 static_cast<int64_t>(ix.lo)]
                                  : 1.0f);
          }
        }
        my_placed[k] = static_cast<PlacedT>(is_placed);
      }
      before += static_cast<int>(rows[j]);
    }
    fresh_before = before;
  }
  if (b == 0 && t == 0) {
    // Placement fills free slots (invalid before) first, then stale ones.
    const int valid_after = n_valid + min(n_place, n_free);
    if (out.n_place) out.n_place[(int64_t)p * out.count_stride] = n_place;
    out.n_valid[(int64_t)p * out.count_stride] = valid_after;
    if (out.n_valid_col) {
      out.n_valid_col[(int64_t)p * out.n_valid_col_stride] = valid_after;
    }
  }
}

// The frontier step's round: grid (kStateCluster, P), one cluster per PE.
template <typename Id, bool kSorted, class Gates, typename PlacedT>
__global__ void __cluster_dims__(kStateCluster, 1, 1)
    __launch_bounds__(kStateThreads)
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
                          StateOut<PlacedT> out,
                          int32_t* __restrict__ rank_slot, Policy pol) {
  const cg::cluster_group cluster = cg::this_cluster();
  state_round<kStateCluster, kStateItems, Id, kSorted>(
      cluster, C, K, gates, ix, ids, scores, valid, accessed, in_cap, weights,
      cand, cand_w, node_weights, ids2, s2, valid2, acc3, w2, out, rank_slot,
      pol);
  cluster.sync();  // keep `counts` alive until every block has read it
}

// Launches prefetch_state_kernel on `s`: grid (kStateCluster, P).
template <typename Id, bool kSorted, class Gates, typename PlacedT>
inline cudaError_t launch_state(int P, int C, int K, Gates gates,
                                const IdIndex<Id>& ix, const Id* ids,
                                const float* scores, const uint8_t* valid,
                                const uint8_t* accessed, const uint8_t* in_cap,
                                const float* weights, const Id* cand,
                                const float* cand_w, const float* node_weights,
                                Id* ids2, float* s2, uint8_t* valid2,
                                uint8_t* acc3, float* w2,
                                const StateOut<PlacedT>& out,
                                int32_t* rank_slot, const Policy& pol,
                                cudaStream_t s) {
  prefetch_state_kernel<Id, kSorted, Gates, PlacedT>
      <<<dim3(kStateCluster, P), kStateThreads, 0, s>>>(
          C, K, gates, ix, ids, scores, valid, accessed, in_cap, weights, cand,
          cand_w, node_weights, ids2, s2, valid2, acc3, w2, out, rank_slot,
          pol);
  return cudaGetLastError();
}

}  // namespace rudder
