// frontier_unique.cu — the staged pipeline's frontier dedup, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/frontier_unique.py::frontier_unique_batch
// (int32 keys) and ::frontier_unique_batch_wide (the same function over
// (hi, lo) int32 word planes of 64-bit keys). Here both are one kernel,
// a template over the key type: int32_t, and int64_t, which CUDA carries
// natively, so no word planes. For row-sorted keys (P, M):
//   first[p, i]  = key[p, i] != (i > 0 ? key[p, i - 1] : -1)
//   remote[p, i] = first[p, i] && is_remote[p, i]
//   ucount[p] = sum_i first[p, i],  rcount[p] = sum_i remote[p, i]
// Spec: repro_torch/kernels/ref.py::frontier_unique_batch.
//
// Two forms of one kernel template (kCompact):
//   the reference's form (rudder_frontier_unique, _wide): is_remote (P, M)
//     in, the two (P, M) masks and the counts out;
//   the sampler's form (rudder_frontier_unique_compact, _compact_wide):
//     is_remote[p, i] = part_of[key[p, i]] != p computed here (part_of
//     int32, indexed by the key, read only at first occurrences; no
//     part_of: nothing is remote), and in place of the masks the
//     compacted ids in flat row order, key.ravel()[first.ravel()] and
//     key.ravel()[remote.ravel()], written through a decoupled look-back
//     scan. Spec: ref.py::frontier_unique_compact.
//
// What bounds it on this card: bytes. Each position reads its key (4 or
// 8 bytes) and its flag (1), and writes two mask bytes, or, compacted,
// its id when it is a first occurrence (a quarter of the sampler's
// positions): a few integer operations a position.
//
// What the design does about it. The (P, M) block is taken flat: a thread
// covers 16 consecutive positions of the P * M array, a block 4,096 (one
// tile), so its loads are 16 bytes wide (four for int32 keys, eight for
// int64, one for the flags) and its mask stores one 16-byte store each.
// The left neighbour of a thread's first key is the previous lane's last
// key (__shfl_up_sync); lane 0 reads one key from memory. The sampler's
// form reads part_of at a thread's first occurrences only. A position at
// pos % M == 0 starts a row and compares against -1. When M is not a
// multiple of 16 a thread's positions may cross row boundaries (rows
// shorter than 16 cross several): its counts split between its rows. The
// counts of a thread's first row go through a segmented warp reduction
// (lanes of one row add up; the rows along a warp never decrease); those
// of its last row (at most one lane of a warp ends a row there) and of
// any row strictly inside its 16 positions are added alone. All of them
// land in per-row shared-memory counts (f | r << 16), which the block adds
// to its rows' global counts with one atomic per row and count. A launch
// is one kernel and nothing else: the global counts, the look-back's tile
// states and a completion ticket live in a scratch block the wrapper
// keeps per device and stream, all zero when a launch starts; the last
// block to finish (the completion ticket) moves the counts into the
// output with atomicExch, which leaves them zero, and zeroes the tile
// states and the ticket. The outputs are written in full: no fill.
//
// The sampler's form: each 4,096-position tile (tile = block index, as in
// CUB's single-pass scan: blocks start in index order) publishes its own
// sums, and warp 0 walks back over its predecessors' states, 32 a step,
// until it meets an inclusive one; meanwhile every thread puts its unique
// ids into shared memory at their offsets in the tile. Then the block
// stores the tile's run of ids at the tile's global offset, neighbouring
// threads on neighbouring ids, and the remote ids the same way. (An A/B on
// phase 8's block, scripts/staged_hooks_ab.py, chose these: a tile ticket
// taken before the loads, reading 4-16 states a lane a step, or storing
// each id from the thread that holds it were each slower.)
//
// Integer atomics commute and the scan's offsets are exact sums, so the
// outputs are bit-identical to the plain version's. Bool outputs are
// written as 0/1 bytes, which is torch.bool's storage. The 16-byte paths
// need 16-byte aligned keys and flags (the wrapper checks and passes
// `vec`); otherwise every position is loaded and stored alone.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "prefetch_state.cuh"  // rudder::block_scan2

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                    // positions a thread
constexpr int kTile = kThreads * kItems;      // positions a block
constexpr int kRowSlots = 256;                // rows a block counts in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kMask31 = (1ull << 31) - 1;

// Scratch (int32 ctl words, all zero between launches): [0] unused, [1]
// the completion ticket, [2, 2 + P) the unique counts, [2 + P, 2 + 2P)
// the remote counts.
struct Counts {
  int32_t* ctl;
  int P;
  __device__ __forceinline__ int32_t* unique(int64_t row) const { return ctl + 2 + row; }
  __device__ __forceinline__ int32_t* remote(int64_t row) const { return ctl + 2 + P + row; }
};

// Look-back tile states: flag (2 bits: 0 not ready, 1 the tile's own
// sums, 2 the sums of every position up to and including the tile) |
// unique sum (31 bits) | remote sum (31 bits), one word so that a reader
// never sees half of an update.
__device__ __forceinline__ uint64_t tile_word(uint64_t flag, uint64_t u, uint64_t r) {
  return (flag << 62) | (u << 31) | r;
}

// f | r << 16 counts of a row, from a thread's segment: into the block's
// shared count of the row, or (a row past kRowSlots of the block's first
// row, only when M < 16) straight into the global counts.
__device__ __forceinline__ void add_row(int64_t row0, int rel, int packed, int* s_cnt,
                                        const Counts& cnt) {
  if (packed == 0) return;
  if (rel < kRowSlots) {
    atomicAdd(&s_cnt[rel], packed);
  } else {
    atomicAdd(cnt.unique(row0 + rel), packed & 0xffff);
    atomicAdd(cnt.remote(row0 + rel), packed >> 16);
  }
}

// Segmented warp sum over lanes of equal `rel` (non-decreasing along the
// warp; dead lanes carry INT_MAX and 0): the last lane of each run adds
// the run's sum.
__device__ __forceinline__ void warp_add_rows(int64_t row0, int rel, int packed,
                                              int* s_cnt, const Counts& cnt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int r2 = __shfl_up_sync(kFull, rel, off);
    const int v2 = __shfl_up_sync(kFull, packed, off);
    if (lane >= off && r2 == rel) packed += v2;
  }
  const int next = __shfl_down_sync(kFull, rel, 1);
  if (lane == 31 || next != rel) add_row(row0, rel, packed, s_cnt, cnt);
}

template <typename Key>
__device__ __forceinline__ void load_keys(const Key* p, Key (&k)[kItems]) {
  constexpr int kVecs = kItems * sizeof(Key) / 16;
  uint4 v[kVecs];
  const uint4* src = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) v[i] = src[i];
  memcpy(k, v, sizeof(v));
}

__device__ __forceinline__ void store_bits(uint8_t* dst, uint32_t bits, int n, bool vec) {
  uint8_t b[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) b[i] = static_cast<uint8_t>((bits >> i) & 1u);
  if (vec && n == kItems) {
    uint4 v;
    memcpy(&v, b, sizeof(v));
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    for (int i = 0; i < n; ++i) dst[i] = b[i];
  }
}

template <typename Key, bool kCompact, bool kVec>
__global__ void __launch_bounds__(kThreads)
    frontier_unique_kernel(int P, int64_t M, int64_t n_pos,
                           const Key* __restrict__ keys,
                           const uint8_t* __restrict__ is_remote,
                           const int32_t* __restrict__ part_of, int64_t n_part,
                           uint8_t* __restrict__ first,
                           uint8_t* __restrict__ remote,
                           Key* __restrict__ uniq, Key* __restrict__ rem,
                           int32_t* __restrict__ counts,
                           int32_t* __restrict__ ctl,
                           unsigned long long* __restrict__ tiles) {
  __shared__ int s_cnt[kRowSlots];
  __shared__ int s_last;
  __shared__ long long s_before[2];
  __shared__ Key s_ids[kCompact ? kTile : 1];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const Counts cnt{ctl, P};
  for (int i = t; i < kRowSlots; i += kThreads) s_cnt[i] = 0;
  __syncthreads();
  // Tile = block index: blocks start in index order, so a tile's
  // look-back waits only on tiles already running or done.
  const int tile = static_cast<int>(blockIdx.x);
  const int64_t tile0 = static_cast<int64_t>(tile) * kTile;
  const int64_t row0 = tile0 / M;
  const int64_t pos0 = tile0 + static_cast<int64_t>(t) * kItems;
  const int64_t left = n_pos - pos0;
  const int n = left <= 0 ? 0 : (left < kItems ? static_cast<int>(left) : kItems);

  Key k[kItems];
  if (kVec && n == kItems) {
    load_keys<Key>(keys + pos0, k);
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) k[i] = i < n ? keys[pos0 + i] : Key(0);
  }
  uint8_t flag[kItems];
  if (!kCompact) {
    if (kVec && n == kItems) {
      const uint4 v = *reinterpret_cast<const uint4*>(is_remote + pos0);
      memcpy(flag, &v, sizeof(v));
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) flag[i] = i < n ? is_remote[pos0 + i] : 0;
    }
  }
  // Only the grid's last live thread is partial, so a live lane's left
  // neighbour in the warp is full.
  Key prev = __shfl_up_sync(kFull, k[kItems - 1], 1);
  if (lane == 0 && n > 0 && pos0 > 0) prev = keys[pos0 - 1];

  int64_t row = n > 0 ? pos0 / M : row0;
  int64_t col = pos0 - row * M;
  uint32_t fbits = 0, rbits = 0;
  int rel_a = INT_MAX, packed_a = 0;  // the first row's counts
  int cur = 0;                        // the current row's f | r << 16
  bool crossed = false;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i < n) {
      const Key key = k[i];
      const bool f = key != (col == 0 ? Key(-1) : prev);
      bool r;
      if (kCompact) {
        r = f && part_of != nullptr && key >= 0 && static_cast<int64_t>(key) < n_part &&
            part_of[key] != row;
      } else {
        r = f && flag[i] != 0;
      }
      fbits |= static_cast<uint32_t>(f) << i;
      rbits |= static_cast<uint32_t>(r) << i;
      cur += static_cast<int>(f) | (static_cast<int>(r) << 16);
      prev = key;
      if (++col == M) {
        col = 0;
        if (i + 1 < n) {  // the row ends inside this thread's positions
          if (!crossed) {
            rel_a = static_cast<int>(row - row0);
            packed_a = cur;
            crossed = true;
          } else {
            add_row(row0, static_cast<int>(row - row0), cur, s_cnt, cnt);
          }
          cur = 0;
          ++row;
        }
      }
    }
  }
  if (n > 0 && !crossed) {
    rel_a = static_cast<int>(row - row0);
    packed_a = cur;
  }
  warp_add_rows(row0, rel_a, packed_a, s_cnt, cnt);
  if (crossed) add_row(row0, static_cast<int>(row - row0), cur, s_cnt, cnt);

  if (!kCompact) {
    store_bits(first + pos0, fbits, n, kVec);
    store_bits(remote + pos0, rbits, n, kVec);
  } else {
    const int nf = __popc(fbits);
    const int nr = __popc(rbits);
    int ex_f, ex_r, tot_f, tot_r;
    rudder::block_scan2(nf, nr, &ex_f, &ex_r, &tot_f, &tot_r);
    // The tile's unique ids into shared memory at their offsets in the
    // tile, while warp 0 looks back.
    {
      int o = ex_f;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if ((fbits >> i) & 1u) s_ids[o++] = k[i];
      }
    }
    if (t < 32) {
      // Look-back by warp 0, 32 predecessors a step: each lane waits for
      // its tile's state; the nearest inclusive state ends the walk.
      if (lane == 0) {
        atomicExch(&tiles[tile], tile_word(tile == 0 ? 2 : 1, tot_f, tot_r));
      }
      long long before_f = 0, before_r = 0;
      for (int j = tile - 1; j >= 0; j -= 32) {
        const int jj = j - lane;
        uint64_t w = tile_word(2, 0, 0);  // before tile 0: an inclusive zero
        if (jj >= 0) {
          do {
            w = *reinterpret_cast<volatile unsigned long long*>(&tiles[jj]);
          } while ((w >> 62) == 0);
        }
        const unsigned inclusive = __ballot_sync(kFull, (w >> 62) == 2);
        const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
        long long a = lane <= stop ? static_cast<long long>((w >> 31) & kMask31) : 0;
        long long b = lane <= stop ? static_cast<long long>(w & kMask31) : 0;
        for (int off = 16; off > 0; off >>= 1) {
          a += __shfl_down_sync(kFull, a, off);
          b += __shfl_down_sync(kFull, b, off);
        }
        before_f += a;  // lane 0 holds the sums
        before_r += b;
        if (inclusive) break;
      }
      if (lane == 0) {
        if (tile > 0) {
          atomicExch(&tiles[tile], tile_word(2, before_f + tot_f, before_r + tot_r));
        }
        s_before[0] = before_f;
        s_before[1] = before_r;
      }
    }
    __syncthreads();
    // Both id runs out of shared memory, neighbouring threads on
    // neighbouring ids: the unique ids, then (the buffer refilled) the
    // remote ones.
    Key* dst = uniq + s_before[0];
    for (int i = t; i < tot_f; i += kThreads) dst[i] = s_ids[i];
    if (rem != nullptr) {
      __syncthreads();
      int o = ex_r;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if ((rbits >> i) & 1u) s_ids[o++] = k[i];
      }
      __syncthreads();
      dst = rem + s_before[1];
      for (int i = t; i < tot_r; i += kThreads) dst[i] = s_ids[i];
    }
  }

  // The block's per-row counts into the global ones, one atomic per row
  // and count.
  __syncthreads();
  const int64_t end = tile0 + kTile < n_pos ? tile0 + kTile : n_pos;
  const int64_t rows = (end - 1) / M - row0 + 1;
  const int slots = rows < kRowSlots ? static_cast<int>(rows) : kRowSlots;
  for (int s = t; s < slots; s += kThreads) {
    const int v = s_cnt[s];
    if (v & 0xffff) atomicAdd(cnt.unique(row0 + s), v & 0xffff);
    if (v >> 16) atomicAdd(cnt.remote(row0 + s), v >> 16);
  }

  // The last block to finish hands out the counts and leaves the scratch
  // clean for the next launch.
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(ctl + 1, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int p = t; p < P; p += kThreads) {
      counts[p] = atomicExch(cnt.unique(p), 0);
      counts[P + p] = atomicExch(cnt.remote(p), 0);
    }
    if (kCompact) {
      for (int i = t; i < static_cast<int>(gridDim.x); i += kThreads) tiles[i] = 0;
    }
    if (t == 0) ctl[1] = 0;
  }
}

template <typename Key, bool kCompact>
int launch(int P, int64_t M, const Key* keys, const uint8_t* is_remote,
           const int32_t* part_of, int64_t n_part, uint8_t* first,
           uint8_t* remote, Key* uniq, Key* rem, int32_t* counts, int32_t* ctl,
           unsigned long long* tiles, int vec, void* stream) {
  const int64_t n_pos = static_cast<int64_t>(P) * M;
  if (P <= 0 || M <= 0) return 0;
  const int64_t n_tiles = (n_pos + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_tiles);
  if (vec) {
    frontier_unique_kernel<Key, kCompact, true><<<grid, kThreads, 0, s>>>(
        P, M, n_pos, keys, is_remote, part_of, n_part, first, remote, uniq, rem,
        counts, ctl, tiles);
  } else {
    frontier_unique_kernel<Key, kCompact, false><<<grid, kThreads, 0, s>>>(
        P, M, n_pos, keys, is_remote, part_of, n_part, first, remote, uniq, rem,
        counts, ctl, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The reference's form: first, remote (P, M) uint8 and counts (2, P) int32
// (unique, then remote) from row-sorted int32 keys and uint8 remote flags,
// on `stream`. ctl: the kept scratch (2 + 2P int32 words, zero between
// launches). vec: keys and flags are 16-byte aligned. Pointers are device
// pointers of contiguous tensors. Returns the cudaError_t of the launch,
// or 0.
extern "C" int rudder_frontier_unique(int P, int64_t M, const int32_t* keys,
                                      const uint8_t* is_remote, uint8_t* first,
                                      uint8_t* remote, int32_t* counts,
                                      int32_t* ctl, int vec, void* stream) {
  return launch<int32_t, false>(P, M, keys, is_remote, nullptr, 0, first, remote,
                                nullptr, nullptr, counts, ctl, nullptr, vec, stream);
}

// The same over int64 keys (the reference's wide twin).
extern "C" int rudder_frontier_unique_wide(int P, int64_t M, const int64_t* keys,
                                           const uint8_t* is_remote,
                                           uint8_t* first, uint8_t* remote,
                                           int32_t* counts, int32_t* ctl,
                                           int vec, void* stream) {
  return launch<int64_t, false>(P, M, keys, is_remote, nullptr, 0, first, remote,
                                nullptr, nullptr, counts, ctl, nullptr, vec, stream);
}

// The sampler's form: uniq (P * M,) and rem (P * M,) (null when part_of is
// null) receive the compacted ids in flat row order, counts (2, P) the
// counts, from row-sorted int32 keys and part_of (n_part int32, or null),
// on `stream`. tiles: the kept look-back states (ceil(P * M / 4096) words,
// zero between launches); P * M < 2^31. Returns the cudaError_t of the
// launch, or 0.
extern "C" int rudder_frontier_unique_compact(int P, int64_t M, const int32_t* keys,
                                              const int32_t* part_of, int64_t n_part,
                                              int32_t* uniq, int32_t* rem,
                                              int32_t* counts, int32_t* ctl,
                                              unsigned long long* tiles, int vec,
                                              void* stream) {
  return launch<int32_t, true>(P, M, keys, nullptr, part_of, n_part, nullptr, nullptr,
                               uniq, rem, counts, ctl, tiles, vec, stream);
}

// The same over int64 keys.
extern "C" int rudder_frontier_unique_compact_wide(int P, int64_t M, const int64_t* keys,
                                                   const int32_t* part_of, int64_t n_part,
                                                   int64_t* uniq, int64_t* rem,
                                                   int32_t* counts, int32_t* ctl,
                                                   unsigned long long* tiles, int vec,
                                                   void* stream) {
  return launch<int64_t, true>(P, M, keys, nullptr, part_of, n_part, nullptr, nullptr,
                               uniq, rem, counts, ctl, tiles, vec, stream);
}
