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
//   (A) frontier_state_kernel, one block per PE: score; free/stale slot
//       ranks and fresh candidate ranks by block-wide scans over contiguous
//       per-thread chunks (ranks follow slot and candidate order);
//       placement, updating slot_of for the probe. Only P blocks: the
//       state is small (C ~ 12.6k, K ~ 25k per PE).
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

namespace {

constexpr int kStateThreads = 1024;
constexpr int kProbeThreads = 256;
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

// Exclusive block-wide scan of two counters at once; returns the totals.
// Every thread of the block must call it.
__device__ void block_scan2(int a, int b, int* excl_a, int* excl_b, int* tot_a,
                            int* tot_b) {
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

// (A) One block per PE: score, rank, place.
__global__ void __launch_bounds__(kStateThreads)
    frontier_state_kernel(int C, int K, int N, int aug_stride,
                          const int32_t* __restrict__ aug,
                          const int32_t* __restrict__ ids,
                          const float* __restrict__ scores,
                          const uint8_t* __restrict__ valid,
                          const uint8_t* __restrict__ accessed,
                          const uint8_t* __restrict__ in_cap,
                          const float* __restrict__ weights,
                          const int32_t* __restrict__ cand,
                          const float* __restrict__ node_weights,
                          int32_t* __restrict__ ids2, float* __restrict__ s2,
                          uint8_t* __restrict__ valid2,
                          uint8_t* __restrict__ acc3, float* __restrict__ w2,
                          uint8_t* __restrict__ placed,
                          int32_t* __restrict__ slot_pos,
                          int32_t* __restrict__ slot_of,
                          int32_t* __restrict__ cand_first,
                          int32_t* __restrict__ rank_slot, Policy pol) {
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int gates = aug[(int64_t)p * aug_stride + (aug_stride - 1)];
  const bool active_score = (gates & 1) != 0;
  const bool do_replace = (gates & 2) != 0;

  const int64_t row_c = (int64_t)p * C;
  const int64_t row_k = (int64_t)p * K;
  const int64_t row_n = (int64_t)p * N;
  int32_t* my_slot_of = slot_of + row_n;
  int32_t* my_cand_first = cand_first + row_n;

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
    const int32_t id = ids[i];
    s2[i] = s;
    ids2[i] = id;
    valid2[i] = v;
    acc3[i] = a && !active_score;
    if (weights) w2[i] = w;
    if (v && id >= 0 && id < N) my_slot_of[id] = c;
    n_free_mine += (!v && in_cap[i] != 0);
    n_stale_mine += (v && s < pol.threshold);
  }
  for (int k = k0; k < k1; ++k) {
    const int32_t id = cand[row_k + k];
    if (id >= 0 && id < N) atomicMin(&my_cand_first[id], k);
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
    const int32_t id = cand[row_k + k];
    const bool fresh = do_replace && id >= 0 && id < N && my_slot_of[id] < 0 &&
                       my_cand_first[id] == k;
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
        const int32_t id = cand[j];
        if (valid[i] != 0) {
          const int32_t old = ids[i];
          if (old >= 0 && old < N) my_slot_of[old] = -1;
        }
        my_slot_of[id] = c;
        ids2[i] = id;
        s2[i] = pol.initial_score;
        valid2[i] = 1;
        acc3[i] = 0;
        if (weights) w2[i] = node_weights ? node_weights[id] : 1.0f;
      }
    }
    placed[j] = is_placed;
  }
}

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
  const Policy pol{increment, decay, threshold, score_cap, initial_score,
                   mode};
  const int aug_stride = Mt + 1;
  frontier_state_kernel<<<P, kStateThreads, 0, s>>>(
      C, K, N, aug_stride, aug, ids, scores, valid, accessed, in_cap, weights,
      cand, node_weights, ids2, s2, valid2, acc3, w2, placed, slot_pos,
      slot_of, cand_first, rank_slot, pol);
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
