// fused_frontier_step.cu — the single-launch prefetch step for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_step.py::fused_frontier_step_pallas
// (the pallas_call body, _make_frontier_kernel + _fused_body) and its wide
// twin fused_frontier_step_wide_pallas (:873): per trainer PE, dedup the
// raw frontier, close the scoring round, run the replacement round (free
// slots first, then stale, in candidate order) and probe the deduplicated
// remote frontier against the post-replace buffer, emitting one
// per-position code (0 local or duplicate, 1 remote miss, 2 + slot remote
// hit), the next launch's candidates (the misses, ascending) and the
// packed readback [sk | code | placed | slot_pos | n_valid]. Spec:
// repro_torch/kernels/ref.py::fused_frontier_step (and its _wide twin).
//
// What bounds it on this card: bytes. The launch reads the raw frontier
// (P x Mt ids), one part_of entry per distinct id and the (P, C) state, and
// writes the packed readback (P x (2 or 3) Mt int32 words) plus the state;
// at P = 4, Mt = 522,000 it is some 28-46 MB of traffic, 9-14 microseconds
// at 3.35 TB/s. Per position it does a handful of integer operations, far
// below any compute roof.
//
// What the design does about it. Every non-negative frontier id lies in
// [id_base, id_base + N), N = len(part_of), so a row sort is a count sort
// over the local ids d = id - id_base, and the frontier's dedup, the
// probe and the miss compaction all become one pass over d in ascending
// order. The launch is two memsets and three kernels on the current
// stream, with no PyTorch op between them and no host sync:
//   memsets  one zero region (counts, cand_first, the row counters of
//            negative keys, the scan's tile states and ticket) and one
//            0xFF region (slot_of), in one scratch block the wrapper keeps
//            for the next launch on its stream.
//   (1) frontier_hist_kernel, grid (blocks, P): 16-byte loads of the raw
//       frontier; counts[p][d] += 1, the warp's equal ids aggregated
//       first (__match_any_sync) so hub ids cost one atomic a warp; -1
//       counted per row; other negative keys gathered per row.
//   (2) prefetch_state_kernel (prefetch_state.cuh), one cluster of 8
//       blocks per PE: score, fill ranks, fresh ranks, placement, updating
//       slot_of for the probe, placed / slot_pos / n_valid written straight
//       into packed's columns, n_place / n_valid into the counters; it also
//       sets cand_next to -1 and the counters' other two words to 0.
//   (3) frontier_expand_kernel, one block per 512 local ids of a row
//       (dynamic tile order) plus one block per row for the negative keys:
//       per distinct d (counts > 0) remoteness (part_of[d] != p) and the
//       probe (slot_of after placement, marking accessed); a single-pass
//       decoupled look-back scan of (counts, misses), one warp reading 32
//       predecessors' states at a time, gives each d its sorted position
//       and each miss its rank in cand_next; the block
//       then writes its whole output range, sk and code, one position a
//       thread (coalesced, a long run of one hub id spread over the
//       block) and a share of the row's -1 keys, and adds n_remote and
//       hits to the counters. The negative block sorts its row's gathered
//       non-(-1) negatives (a bitonic network in place; the engine only
//       pads with -1, so it is empty on every trainer launch) and writes
//       them ahead of the -1s.
// Integer atomics commute, so nothing depends on their order: the outputs
// are bit-identical to the plain version's.
//
// A wide launch whose scratch would pass the wrapper's memory budget (ids
// spread over a span of 2^40, say) takes the sorted route instead
// (rudder_fused_frontier_step_wide_sorted): the wrapper row-sorts the
// frontier and the IdIndex's sorted rows with torch.sort, the state round
// runs in the index's sorted mode, frontier_probe_kernel codes the sorted
// frontier by binary searches, and the miss compaction and packing stay
// PyTorch ops (ref.frontier_pack_wide).
//
// Two id widths: int32 (rudder_fused_frontier_step, id_base 0) and int64
// at any id_base up to WIDE_ID_MAX (rudder_fused_frontier_step_wide), whose
// (hi, lo) word planes in the reference int64 replaces. A wide key goes
// into packed as two int32 words written one at a time: the row stride
// 3 Mt + K + C + 1 may be odd, and an 8-byte store would then be
// misaligned.
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

constexpr int kHistThreads = 256;
constexpr int kHistMaxBlocks = 1024;
constexpr int kExpandThreads = 256;
constexpr int kExpandItems = 2;
constexpr int kTile = kExpandThreads * kExpandItems;  // local ids a tile
constexpr int kProbeThreads = 256;

// Tile states of the look-back scan: flag (2 bits: 0 not ready, 1 the
// tile's own sums, 2 the sums of the row up to and including the tile) |
// count sum (31 bits) | miss sum (31 bits), one word so that a reader never
// sees half of an update.
constexpr uint64_t kMask31 = (1ull << 31) - 1;
__device__ __forceinline__ uint64_t tile_word(uint64_t flag, uint64_t count,
                                              uint64_t miss) {
  return (flag << 62) | (count << 31) | miss;
}

// A key into row `out` of packed at sorted position q: one word on the
// narrow path, two (low, high) on the wide one.
__device__ __forceinline__ void put_key(int32_t* out, int64_t q, int32_t v) {
  out[q] = v;
}
__device__ __forceinline__ void put_key(int32_t* out, int64_t q, int64_t v) {
  const uint64_t u = static_cast<uint64_t>(v);
  out[2 * q] = static_cast<int32_t>(static_cast<uint32_t>(u));
  out[2 * q + 1] = static_cast<int32_t>(static_cast<uint32_t>(u >> 32));
}

// Negative keys of a row: neg[p][0] counts the -1s, neg[p][1] the others,
// which are gathered into others[p][0, neg[p][1]).
template <typename Id>
__device__ __forceinline__ void hist_key(Id v, bool live, int p, int N, Id lo,
                                         int32_t* counts, int32_t* neg,
                                         Id* others, int Mt) {
  // tag: local id d >= 0; -1 for a -1 key; -2 for another negative key;
  // -3 for nothing (a dead lane, or an id outside [lo, lo + N)).
  int tag = -3;
  if (live) {
    if (v >= 0) {
      const int64_t d = static_cast<int64_t>(v) - static_cast<int64_t>(lo);
      if (d >= 0 && d < N) tag = static_cast<int>(d);
    } else {
      tag = v == Id(-1) ? -1 : -2;
    }
  }
  const unsigned peers = __match_any_sync(0xffffffffu, tag);
  const int lane = threadIdx.x & 31;
  if (lane == __ffs(peers) - 1) {
    if (tag >= 0) {
      atomicAdd(&counts[(int64_t)p * N + tag], __popc(peers));
    } else if (tag == -1) {
      atomicAdd(&neg[2 * p], __popc(peers));
    }
  }
  if (tag == -2) {
    const int at = atomicAdd(&neg[2 * p + 1], 1);
    others[(int64_t)p * Mt + at] = v;
  }
}

// (1) The count sort's histogram. Row p of the raw (P, Mt + 1) block in
// three parts: the head before its first 16-byte boundary and the tail
// after its last whole vector (both below one vector, taken by warp 0 of
// block 0), and the vectors between, one a thread. Loops are warp-uniform
// so that every lane reaches __match_any_sync.
template <typename Id>
__global__ void __launch_bounds__(kHistThreads)
    frontier_hist_kernel(int Mt, int N, Id lo, const Id* __restrict__ aug,
                         int32_t* __restrict__ counts, int32_t* __restrict__ neg,
                         Id* __restrict__ others) {
  constexpr int V = 16 / sizeof(Id);
  const int p = blockIdx.y;
  const Id* row = aug + (int64_t)p * (Mt + 1);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  const int head = min(static_cast<int>(((16 - (addr & 15)) & 15) / sizeof(Id)), Mt);
  const int nvec = (Mt - head) / V;
  const int tail0 = head + nvec * V;
  const int lane = threadIdx.x & 31;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsize = gridDim.x * blockDim.x;

  if (blockIdx.x == 0 && threadIdx.x < 32) {
    // head + tail < 2 V <= 8 keys.
    const int n_tail = Mt - tail0;
    int m = -1;
    if (lane < head) {
      m = lane;
    } else if (lane - head < n_tail) {
      m = tail0 + (lane - head);
    }
    hist_key<Id>(m >= 0 ? row[m] : Id(0), m >= 0, p, N, lo, counts, neg,
                 others, Mt);
  }
  const int4* body = reinterpret_cast<const int4*>(row + head);
  for (int base = gtid - lane; base < nvec; base += gsize) {
    const int j = base + lane;
    const bool live = j < nvec;
    int4 raw = make_int4(0, 0, 0, 0);
    if (live) raw = body[j];
    const Id* keys = reinterpret_cast<const Id*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      hist_key<Id>(keys[e], live, p, N, lo, counts, neg, others, Mt);
    }
  }
}

// (3) Look-back scan, probe and expansion over the local ids; see the
// note at the top. `ticket` hands out work in launch order: row-major
// tiles first (a tile only waits on lower tiles of its row, which hold
// lower tickets and so are already running), then one block per row for
// the negative keys.
template <typename Id>
__global__ void __launch_bounds__(kExpandThreads)
    frontier_expand_kernel(int P, int C, int Mt, int N, int n_tiles, int kc,
                           int64_t W, Id lo, const Id* __restrict__ aug,
                           const int32_t* __restrict__ part_of,
                           const int32_t* __restrict__ counts,
                           const int32_t* __restrict__ neg,
                           Id* __restrict__ others,
                           const int32_t* __restrict__ slot_of,
                           uint8_t* __restrict__ acc3,
                           unsigned long long* __restrict__ tiles,
                           int32_t* __restrict__ ticket,
                           int32_t* __restrict__ packed,
                           Id* __restrict__ cand_next,
                           int32_t* __restrict__ counters) {
  constexpr int64_t kKeyWords = sizeof(Id) / 4;
  __shared__ int s_job;
  __shared__ int s_off[kTile];
  __shared__ int s_code[kTile];
  __shared__ long long s_before[2];
  const int t = threadIdx.x;
  if (t == 0) s_job = atomicAdd(ticket, 1);
  __syncthreads();
  const int job = s_job;

  if (job >= P * n_tiles) {
    // -- the negative keys of row p: sorted others, then the -1s ------- //
    const int p = job - P * n_tiles;
    const int n_o = neg[2 * p + 1];
    Id* buf = others + (int64_t)p * Mt;
    int n2 = 1;
    while (n2 < n_o) n2 <<= 1;
    // Bitonic network, every comparator ascending; keys past n_o are a
    // virtual +inf that never moves, so only pairs inside [0, n_o) swap.
    for (int k = 2; k <= n2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < n2 / 2; i += blockDim.x) {
          const int grp = i / j, in = i % j;
          int a, c;
          if (j == (k >> 1)) {  // the flip of a k-block
            a = (i / j) * k + in;
            c = (i / j) * k + k - 1 - in;
          } else {  // a half-cleaner of width 2j
            a = grp * 2 * j + in;
            c = a + j;
          }
          if (c < n_o) {
            const Id x = buf[a], y = buf[c];
            if (y < x) {
              buf[a] = y;
              buf[c] = x;
            }
          }
        }
        __syncthreads();
      }
    }
    // The -1s that follow are the tiles' to write, or this block's when
    // the row has no tile (N == 0).
    int32_t* out = packed + (int64_t)p * W;
    const int q1 = n_tiles > 0 ? n_o : n_o + neg[2 * p];
    for (int q = t; q < q1; q += blockDim.x) {
      put_key(out, q, q < n_o ? buf[q] : Id(-1));
      out[kKeyWords * Mt + q] = 0;
    }
    return;
  }

  // -- a tile of row p's local ids -------------------------------------- //
  const int p = job / n_tiles;
  const int tile = job % n_tiles;
  const bool active_probe = (aug[(int64_t)p * (Mt + 1) + Mt] & 4) != 0;
  const int d0 = tile * kTile + t * kExpandItems;
  const int32_t* my_counts = counts + (int64_t)p * N;
  const int32_t* my_slot_of = slot_of + (int64_t)p * N;
  uint8_t* my_acc3 = acc3 + (int64_t)p * C;

  int cnt[kExpandItems];
  int code[kExpandItems];
  int n_count = 0, n_miss = 0, n_remote = 0, n_hit = 0;
#pragma unroll
  for (int i = 0; i < kExpandItems; ++i) {
    const int d = d0 + i;
    cnt[i] = d < N ? my_counts[d] : 0;
    code[i] = 0;
    if (cnt[i] > 0 && part_of[d] != p) {
      code[i] = 1;
      ++n_remote;
      if (active_probe) {
        const int32_t slot = my_slot_of[d];
        if (slot >= 0) {
          code[i] = slot + 2;
          my_acc3[slot] = 1;
          ++n_hit;
        }
      }
      n_miss += code[i] == 1;
    }
    n_count += cnt[i];
  }
  int excl_count, excl_miss, tile_count, tile_miss;
  rudder::block_scan2(n_count, n_miss, &excl_count, &excl_miss, &tile_count,
                      &tile_miss);

  if (t < 32) {
    // Look-back by warp 0, 32 predecessors a step: each lane waits for its
    // tile's state; the nearest inclusive state ends the walk, and the
    // aggregates up to it are summed.
    unsigned long long* mine = tiles + (int64_t)p * n_tiles;
    const int lane = t;
    if (lane == 0) {
      atomicExch(&mine[tile], tile_word(tile == 0 ? 2 : 1, tile_count, tile_miss));
    }
    long long before_count = 0, before_miss = 0;
    for (int j = tile - 1; j >= 0; j -= 32) {
      const int jj = j - lane;
      uint64_t w = tile_word(2, 0, 0);  // before tile 0: an inclusive zero
      if (jj >= 0) {
        do {
          w = *reinterpret_cast<volatile unsigned long long*>(&mine[jj]);
        } while ((w >> 62) == 0);
      }
      const unsigned inclusive = __ballot_sync(0xffffffffu, (w >> 62) == 2);
      const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
      long long c = lane <= stop ? static_cast<long long>((w >> 31) & kMask31) : 0;
      long long m = lane <= stop ? static_cast<long long>(w & kMask31) : 0;
      for (int off = 16; off > 0; off >>= 1) {
        c += __shfl_down_sync(0xffffffffu, c, off);
        m += __shfl_down_sync(0xffffffffu, m, off);
      }
      before_count += c;  // lane 0 holds the sums
      before_miss += m;
      if (inclusive) break;
    }
    if (lane == 0) {
      if (tile > 0) {
        atomicExch(&mine[tile], tile_word(2, before_count + tile_count,
                                          before_miss + tile_miss));
      }
      s_before[0] = before_count;
      s_before[1] = before_miss;
    }
  }
  __syncthreads();
  const int n_neg = neg[2 * p] + neg[2 * p + 1];
  const int64_t range0 = n_neg + s_before[0];  // the tile's first position
  int off = static_cast<int>(range0) + excl_count;
  int rank = static_cast<int>(s_before[1]) + excl_miss;
#pragma unroll
  for (int i = 0; i < kExpandItems; ++i) {
    const int d = d0 + i;
    s_off[t * kExpandItems + i] = off;
    s_code[t * kExpandItems + i] = code[i];
    if (code[i] == 1) {
      if (rank < kc) cand_next[(int64_t)p * kc + rank] = lo + static_cast<Id>(d);
      ++rank;
    }
    off += cnt[i];
  }
  int unused_a, unused_b, tile_remote, tile_hit;
  rudder::block_scan2(n_remote, n_hit, &unused_a, &unused_b, &tile_remote,
                      &tile_hit);  // also orders the s_off / s_code stores
  if (t == 0) {
    if (tile_remote) atomicAdd(&counters[4 * p], tile_remote);
    if (tile_hit) atomicAdd(&counters[4 * p + 1], tile_hit);
  }

  // Expansion: position q of [range0, range0 + tile_count) holds the id
  // of the last item whose offset is <= q (an item with no count shares
  // its offset with the next one, so that search never stops on it); its
  // first position carries the code, the rest 0.
  int32_t* out = packed + (int64_t)p * W;
  // A share of the row's -1 keys, which follow its other negative keys:
  // spread over the row's tiles (a padded row can hold hundreds of
  // thousands of them).
  {
    const int n_o = neg[2 * p + 1];
    const int share = (neg[2 * p] + n_tiles - 1) / n_tiles;
    const int q1 = min(n_o + (tile + 1) * share, n_neg);
    for (int q = n_o + tile * share + t; q < q1; q += blockDim.x) {
      put_key(out, q, Id(-1));
      out[kKeyWords * Mt + q] = 0;
    }
  }
  const int64_t range1 = range0 + tile_count;
  const int tile_d0 = tile * kTile;
  for (int64_t q = range0 + t; q < range1; q += blockDim.x) {
    int a = 0, b = kTile;  // upper bound of q in s_off
    while (a < b) {
      const int m = (a + b) >> 1;
      if (s_off[m] <= q) {
        a = m + 1;
      } else {
        b = m;
      }
    }
    const int j = a - 1;
    put_key(out, q, lo + static_cast<Id>(tile_d0 + j));
    out[kKeyWords * Mt + q] = q == s_off[j] ? s_code[j] : 0;
  }
}

// The sorted route's probe: dedup, probe and code over the row-sorted
// frontier sk, by binary searches of the IdIndex's sorted rows.
template <typename Id>
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
      const int32_t slot =
          rudder::sorted_lookup(ix, p, C, K, v, ids2, valid2,
                                placed + (int64_t)p * K);
      if (slot >= 0) {
        out = slot + 2;
        acc3[(int64_t)p * C + slot] = 1;
      }
    }
  }
  code[row + m] = out;
}

template <typename Id>
int launch_direct(int P, int C, int K, int Mt, int N, int kc, int n_tiles,
                  Id lo, const Id* aug, const Id* ids, const float* scores,
                  const uint8_t* valid, const uint8_t* accessed,
                  const uint8_t* in_cap, const float* weights,
                  const int32_t* part_of, const Id* cand,
                  const float* node_weights, Id* ids2, float* s2,
                  uint8_t* valid2, uint8_t* acc3, float* w2, int32_t* packed,
                  void* zero, int64_t zero_bytes, void* ones,
                  int64_t ones_bytes, int32_t* counters, int32_t* neg,
                  int32_t* ticket, unsigned long long* tiles,
                  int32_t* cand_first, int32_t* counts, Id* cand_next,
                  int32_t* slot_of, int32_t* rank_slot, Id* others,
                  const rudder::Policy& pol, cudaStream_t s) {
  if (P <= 0) return 0;
  if ((int64_t)n_tiles * kTile < N) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(zero, 0, zero_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(ones, 0xFF, ones_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int64_t kKeyWords = sizeof(Id) / 4;
  const int64_t W = (kKeyWords + 1) * Mt + K + C + 1;
  if (Mt > 0) {
    const int nvec = Mt / (16 / static_cast<int>(sizeof(Id))) + 1;
    const int blocks = min((nvec + kHistThreads - 1) / kHistThreads, kHistMaxBlocks);
    frontier_hist_kernel<Id><<<dim3(blocks, P), kHistThreads, 0, s>>>(
        Mt, N, lo, aug, counts, neg, others);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const rudder::IdIndex<Id> ix{lo, N, slot_of, cand_first};
  const rudder::StateOut<int32_t> out{
      packed + (kKeyWords + 1) * Mt, W, packed + (kKeyWords + 1) * Mt + K, W,
      counters + 2, counters + 3, 4, packed + (W - 1), W,
      reinterpret_cast<uint32_t*>(cand_next), kc * kKeyWords, counters};
  err = rudder::launch_state<Id, false>(
      P, C, K, rudder::PackedGates<Id>{aug, Mt + 1}, ix, ids, scores, valid,
      accessed, in_cap, weights, cand, static_cast<const float*>(nullptr),
      node_weights, ids2, s2, valid2, acc3, w2, out, rank_slot, pol, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  frontier_expand_kernel<Id><<<P * n_tiles + P, kExpandThreads, 0, s>>>(
      P, C, Mt, N, n_tiles, kc, W, lo, aug, part_of, counts, neg, others,
      slot_of, acc3, tiles, ticket, packed, cand_next, counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The direct route, int32 ids in [0, N) or negative padding. Pointers are
// device pointers; `weights`, `w2` and `node_weights` may be null (the
// unweighted policies). Outputs besides the state: `packed`, the
// (P, 2 Mt + K + C + 1) readback, `cand_next` (P, kc) and `counters`
// (P, 4), which the state round initialises (-1, and 0 before the expand
// kernel's atomics). The scratch pointers lie in two regions, [zero,
// zero + zero_bytes) cleared to 0 here (neg, ticket, tiles, cand_first,
// counts) and [ones, ones + ones_bytes) set to -1 (slot_of); rank_slot
// (P, C) and others (P, Mt) need no clearing; `tiles` holds
// n_tiles = ceil(N / 512) states a row. Returns the cudaError_t of the
// first failed memset or launch, or 0.
extern "C" int rudder_fused_frontier_step(
    int P, int C, int K, int Mt, int N, int kc, int n_tiles,
    const int32_t* aug, const int32_t* ids, const float* scores,
    const uint8_t* valid, const uint8_t* accessed, const uint8_t* in_cap,
    const float* weights, const int32_t* part_of, const int32_t* cand,
    const float* node_weights, int32_t* ids2, float* s2, uint8_t* valid2,
    uint8_t* acc3, float* w2, int32_t* packed, void* zero, int64_t zero_bytes,
    void* ones, int64_t ones_bytes, int32_t* counters, int32_t* neg,
    int32_t* ticket, unsigned long long* tiles, int32_t* cand_first,
    int32_t* counts, int32_t* cand_next, int32_t* slot_of,
    int32_t* rank_slot, int32_t* others, float increment, float decay,
    float threshold, float score_cap, float initial_score, int mode,
    void* stream) {
  const rudder::Policy pol{increment, decay, threshold, score_cap,
                           initial_score, mode};
  return launch_direct<int32_t>(
      P, C, K, Mt, N, kc, n_tiles, 0, aug, ids, scores, valid, accessed,
      in_cap, weights, part_of, cand, node_weights, ids2, s2, valid2, acc3, w2,
      packed, zero, zero_bytes, ones, ones_bytes, counters, neg, ticket, tiles,
      cand_first, counts, cand_next, slot_of, rank_slot, others, pol,
      static_cast<cudaStream_t>(stream));
}

// The direct route on int64 ids: frontier ids lie in [id_base, id_base + N)
// or are negative padding; `packed` is (P, 3 Mt + K + C + 1); otherwise as
// rudder_fused_frontier_step.
extern "C" int rudder_fused_frontier_step_wide(
    int P, int C, int K, int Mt, int N, int kc, int n_tiles, int64_t id_base,
    const int64_t* aug, const int64_t* ids, const float* scores,
    const uint8_t* valid, const uint8_t* accessed, const uint8_t* in_cap,
    const float* weights, const int32_t* part_of, const int64_t* cand,
    const float* node_weights, int64_t* ids2, float* s2, uint8_t* valid2,
    uint8_t* acc3, float* w2, int32_t* packed, void* zero, int64_t zero_bytes,
    void* ones, int64_t ones_bytes, int32_t* counters, int32_t* neg,
    int32_t* ticket, unsigned long long* tiles, int32_t* cand_first,
    int32_t* counts, int64_t* cand_next, int32_t* slot_of,
    int32_t* rank_slot, int64_t* others, float increment, float decay,
    float threshold, float score_cap, float initial_score, int mode,
    void* stream) {
  const rudder::Policy pol{increment, decay, threshold, score_cap,
                           initial_score, mode};
  return launch_direct<int64_t>(
      P, C, K, Mt, N, kc, n_tiles, id_base, aug, ids, scores, valid, accessed,
      in_cap, weights, part_of, cand, node_weights, ids2, s2, valid2, acc3, w2,
      packed, zero, zero_bytes, ones, ones_bytes, counters, neg, ticket, tiles,
      cand_first, counts, cand_next, slot_of, rank_slot, others, pol,
      static_cast<cudaStream_t>(stream));
}

// The sorted route on int64 ids (a launch past the wrapper's map budget):
// `sk` is the row-sorted frontier; res_sorted / res_order / cand_sorted /
// cand_order / cand_slot are the rows of rudder_fused_step_wide's sorted
// mode (fused_step.cu). Writes the state, code (P, Mt), placed (P, K),
// slot_pos (P, C), n_place and n_valid (P,); the wrapper packs them.
extern "C" int rudder_fused_frontier_step_wide_sorted(
    int P, int C, int K, int Mt, int N, int64_t id_base, const int64_t* aug,
    const int64_t* sk, const int64_t* ids, const float* scores,
    const uint8_t* valid, const uint8_t* accessed, const uint8_t* in_cap,
    const float* weights, const int32_t* part_of, const int64_t* cand,
    const float* node_weights, int64_t* ids2, float* s2, uint8_t* valid2,
    uint8_t* acc3, float* w2, int32_t* code, uint8_t* placed,
    int32_t* slot_pos, int32_t* n_place, int32_t* n_valid, int32_t* rank_slot,
    const int64_t* res_sorted, const int64_t* res_order,
    const int64_t* cand_sorted, const int64_t* cand_order, int32_t* cand_slot,
    float increment, float decay, float threshold, float score_cap,
    float initial_score, int mode, void* stream) {
  if (P <= 0) return 0;
  const rudder::Policy pol{increment, decay, threshold, score_cap,
                           initial_score, mode};
  const rudder::IdIndex<int64_t> ix{id_base,     N,          nullptr,
                                    nullptr,     res_sorted, res_order,
                                    cand_sorted, cand_order, cand_slot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const rudder::StateOut<uint8_t> out{placed, K, slot_pos, C, n_place,
                                      n_valid, 1, nullptr, 0};
  cudaError_t err = rudder::launch_state<int64_t, true>(
      P, C, K, rudder::PackedGates<int64_t>{aug, Mt + 1}, ix, ids, scores,
      valid, accessed, in_cap, weights, cand,
      static_cast<const float*>(nullptr), node_weights, ids2, s2, valid2, acc3,
      w2, out, rank_slot, pol, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Mt > 0) {
    dim3 grid((Mt + kProbeThreads - 1) / kProbeThreads, P);
    frontier_probe_kernel<int64_t><<<grid, kProbeThreads, 0, s>>>(
        C, K, Mt, N, Mt + 1, ix, aug, sk, part_of, ids2, valid2, placed, code,
        acc3);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
