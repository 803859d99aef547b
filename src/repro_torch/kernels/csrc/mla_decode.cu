// mla_decode.cu — MLA latent flash-decode for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mla_decode.py::mla_flash_decode (the
// pallas_call body _mla_decode_kernel). For one new token of each of B
// requests it computes the latent context
//   out[b, h, :] = softmax_s(mask_s((q_lat[b,h]·c[b,s] + q_rope[b,h]·kr[b,s])
//                                   * scale)) @ c[b, :, :]
// over the rows s <= pos of the latent cache c (B, S, R) and the shared rope
// key kr (B, S, RR), with float32 scores, softmax and accumulator, written in
// the inputs' dtype (float32, or bfloat16 rounded to nearest even). One pos
// serves the whole batch. Spec: repro_torch/kernels/ref.py::
// mla_latent_attention, which this matches to allclose (1e-4 in float32,
// 3e-2 in bfloat16).
//
// Two kernels, chosen by the wrapper from the dtype:
// * bfloat16: mla_tc_kernel, both products on the tensor cores (wgmma) from
//   row tiles that TMA brings into shared memory;
// * float32: mla_split_kernel, both products on the CUDA cores in float32
//   (fmaf), so that float32 serving keeps its float32 products (greedy
//   tokens identical to the CPU's, logits within 1e-5).
// Both write per-split partial states that mla_combine_kernel merges.
//
// What bounds it on this card (at decode_32k: B 128, S 32,768, H 128, r 512,
// rr 64, bf16, pos S - 1): every head of a request reads the same cache rows
// (MLA is multi-query attention in latent space), so the bytes are one read
// of rows 0..pos of c and kr plus the queries and the output, 4.87 GB, 1.45 ms
// at 3.35 TB/s; the operations are 2·H·(2r + rr) per row, 1.17e12, 1.18 ms at
// the 989 TFLOP/s of the bf16 tensor cores. Both bounds are close (about
// 2·128 operations per cache element against the card's ridge of ~295 per
// byte); the bytes bind. On the CUDA cores (67 TFLOP/s in float32) the same
// operations take 17.5 ms, so only the tensor cores can come near the bound.
//
// What the tensor-core design does about it:
// * Heads are wgmma's M. A block takes 64 heads of one request and one split
//   of its rows. Scores S (64 x 64) = [q_lat | q_rope] (64 x K) · [c | kr]ᵀ,
//   K = r + rr padded to 64-column chunks (576 at r 512: 36 k-steps of 16);
//   context O (64 x r) += P (64 x 64) · c (64 x r). Both products read ONE
//   shared-memory tile of 64 rows of [c | kr], stored by TMA in 64-column,
//   128-byte-swizzled chunks: the scores use it as a K-major B operand, the
//   context its first chunks as an MN-major (transposed) B operand. A tile is
//   read from device memory once per block, never widened and never copied.
// * Registers decide the split: a 64 x 512 float32 accumulator is 256
//   registers a thread for one warpgroup. Two consumer warpgroups each own
//   half of the r columns of O (128 accumulator registers a thread at r 512)
//   and half of the tile's rows for the scores (m64n32: each score is
//   computed once). Their row maxima meet in shared memory each tile, so both
//   hold the same running max and alpha; each writes its 32 columns of P,
//   rounded to bf16, into one 64 x 64 P tile (8 KB, a swizzled A operand)
//   that both context products read; the normaliser is summed per
//   warpgroup and added at the end. A third warpgroup is the producer: one
//   thread starts the TMA loads; setmaxnreg gives it 40 registers and the
//   consumers 232. (A first version had each consumer compute the scores of
//   the whole tile, 1.53x the operations, and keep P in registers as A
//   fragments; chip_smoke.py timed it at 3.36-3.40 ms at decode_32k, and this
//   one at 2.79-2.82 ms, in two runs on an H100 80GB HBM3 at 700 W.)
// * At H 128 a request's two 64-head blocks are grid neighbours (the head
//   block is blockIdx.x), so they run at the same time and the second read of
//   each row tile can be an L2 hit. The other order (head block slowest)
//   measured 3.096 and 3.089 ms against this one's 2.711 and 2.949 at
//   decode_32k (scripts/mla_decode_ab.py, in turns, H100 80GB HBM3 at
//   700 W): not resolved. A cluster of 2 with TMA multicast would also halve
//   the L2 traffic; it is not built.
// * A ring of row tiles fed by cp.async.bulk.tensor under full/empty
//   mbarriers: 227 KB of shared memory hold the 64 x 576 queries (73,728 B),
//   two 73,728 B stages, the P tile and the row maxima at r 512 (up to 4
//   stages at small widths; tc_layout sizes the ring on the host). A stage
//   is released as soon as its context product is done, so the next tile's
//   load runs under a whole tile of work, and a one-stage ring (which rows
//   wider than r 512 + rr 64 need) does not deadlock. Releasing it after
//   the next tile's scores measured 3.037 and 2.925 ms against 2.711 and
//   2.949 (not resolved); one stage 4.010 and 3.873 ms (the same run). The
//   tensor maps are encoded on the host at each call (cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint: no -lcuda) and passed as __grid_constant__
//   parameters. Their row extent is n_valid = pos + 1, not S: TMA zero-fills
//   every row past pos and never reads one, so a masked row contributes
//   0 · 0 and a stale row that holds NaN or Inf cannot leak into the product
//   (p = 0 times NaN is NaN on the tensor cores).
// * P is rounded to bf16 for the context product; the normaliser l sums
//   the float32 p. Rounding P to bf16 is what the reference's own XLA decode
//   does (src/repro/models/attention.py: probs.astype(cache dtype)); against
//   the float32 plain version it stays inside the 3e-2 bar.
// * Softmax in base 2: log2(e) is folded into the scale and exp2f is used;
//   the partial max is written back in natural units for the merge.
// * The rows are split over the grid (flash-decoding) as before, in whole
//   64-row tiles: one split when the blocks of whole requests fill a wave
//   (decode_32k: 256 blocks, one a SM by shared memory, 1.94 waves), else
//   as many as give one wave, at most one per tile (the serve shape, B 4:
//   8 blocks x 5 splits, one tile each, the least a block can do). The
//   splits are merged by log-sum-exp in mla_combine_kernel.
// * Numerics as the Pallas kernel: alpha = 0 while the running max is still
//   NEG_INF, exact-zero p on masked rows, out = acc / max(l, 1e-30) rounded
//   to nearest even.
// * Every shape the wrapper takes: R in {32, ..., 512} (R 32 reads a 64-wide
//   box whose columns past R TMA fills with zeros), RR any multiple of 4
//   (rope chunks zero-padded to 64 columns; where 2·RR is not a multiple of
//   16, TMA cannot address the rows, and the producer warpgroup stages kr
//   with plain loads), any H (query rows past H are zeros and are never
//   stored), B, S and pos. Where the 64 queries and one ring stage do not
//   fit in shared memory together (padded rows past 832 columns: r 512 with
//   rr past 320, r 32 with rr past 768), the queries are not kept resident
//   but staged one 64-column chunk at a time for each tile's scores
//   (kQResident false: 8 KB instead of up to 155 KB). So every r + rr up to
//   1184, the widest the float32 kernel takes, runs (the layout fits rows
//   of up to 26 padded chunks); slowly, which only such rows pay: residency is a template
//   parameter, as a run-time branch slowed the resident path at
//   decode_32k.
//
// The CUDA-core float32 kernel: a block owns 16 heads of one request and a
// split of the rows, stages 32 rows of [c | kr] as float32 in shared memory
// for all 16 heads, and does both products with fmaf (so -fmad=false, set for
// every source of the port, does not split them); expf; the same guards.

#include <cuda.h>  // CUtensorMap and its enums (no -lcuda: see encode_tiled)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 16;  // heads per block
constexpr int kRows = 32;   // cache rows per shared-memory tile
constexpr int kMaxSplits = 1024;
constexpr float kNegInf = -2.3819763e38f;

// Row stride of the shared-memory tiles, in floats: D rounded up to 32, plus
// 4, so that the 8 rows read by a quarter-warp's 16-byte loads start in 8
// different 4-bank groups.
__host__ __device__ inline int padded_dim(int d) { return ((d + 31) / 32) * 32 + 4; }

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One split of one request's rows for 16 heads: the unnormalised float32
// context acc (R per head) and the running max m and normaliser l of the
// online softmax, into part_acc (B, H, n_split, R) and part_ml
// (B, H, n_split, 2). Grid (ceil(H / 16), n_split, B).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 2)
    mla_split_kernel(int H, int S, int RR, int n_valid, int chunk, float scale,
                     const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                     const T* __restrict__ cache_c, const T* __restrict__ cache_kr,
                     float* __restrict__ part_acc, float* __restrict__ part_ml) {
  // Context layout: TK threads across the R columns, TH head rows of
  // threads; each thread accumulates NH heads × NK columns in registers.
  constexpr int TK = R < 256 ? R : 256;
  constexpr int TH = kThreads / TK;
  constexpr int NK = R / TK;
  constexpr int NH = kHeads / TH;
  static_assert(TH * TK == kThreads && NH * TH == kHeads, "layout");

  const int D = R + RR;
  const int D4 = D / 4;
  const int R4 = R / 4;
  const int Dp = padded_dim(D);
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // kHeads × Dp
  float* kv_s = q_s + kHeads * Dp;               // kRows × Dp
  float* p_s = kv_s + kRows * Dp;                // kHeads × kRows
  float* alpha_s = p_s + kHeads * kRows;         // kHeads

  const int t = threadIdx.x;
  const int h0 = blockIdx.x * kHeads;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int b = blockIdx.z;
  const int row_begin = split * chunk;
  const int row_end = min(row_begin + chunk, n_valid);

  // The block's queries [q_lat | q_rope] as float32; heads past H are zero.
  for (int e = t; e < kHeads * D4; e += kThreads) {
    const int hh = e / D4;
    const int c4 = e - hh * D4;
    const int h = h0 + hh;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h < H) {
      const int64_t bh = (int64_t)b * H + h;
      v = c4 < R4 ? load4(q_lat + bh * R + c4 * 4)
                  : load4(q_rope + bh * RR + (c4 - R4) * 4);
    }
    *reinterpret_cast<float4*>(q_s + hh * Dp + c4 * 4) = v;
  }

  // Score layout: a half-warp per head (sh), each lane two rows (ss, ss+16).
  const int sh = t >> 4;
  const int ss = t & 15;
  float m_run = kNegInf;
  float l_run = 0.f;

  const int hc = t / TK;
  const int kc = t - hc * TK;
  float acc[NH][NK];
#pragma unroll
  for (int i = 0; i < NH; ++i)
#pragma unroll
    for (int j = 0; j < NK; ++j) acc[i][j] = 0.f;

  for (int s0 = row_begin; s0 < row_end; s0 += kRows) {
    const int rows = min(kRows, row_end - s0);
    __syncthreads();  // the previous tile's readers are done (and q_s is staged)
    for (int e = t; e < kRows * D4; e += kThreads) {
      const int s = e / D4;
      const int c4 = e - s * D4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < rows) {
        const int64_t row = (int64_t)b * S + s0 + s;
        v = c4 < R4 ? load4(cache_c + row * R + c4 * 4)
                    : load4(cache_kr + row * RR + (c4 - R4) * 4);
      }
      *reinterpret_cast<float4*>(kv_s + s * Dp + c4 * 4) = v;
    }
    __syncthreads();

    // Scores of head sh on rows ss and ss + 16, then the online softmax of
    // the tile, reduced over the half-warp that holds the head.
    {
      const float* q = q_s + sh * Dp;
      const float* x0 = kv_s + ss * Dp;
      const float* x1 = kv_s + (ss + 16) * Dp;
      float a0 = 0.f, a1 = 0.f;
      for (int c = 0; c < D; c += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(q + c);
        const float4 u = *reinterpret_cast<const float4*>(x0 + c);
        const float4 w = *reinterpret_cast<const float4*>(x1 + c);
        a0 = fmaf(qv.x, u.x, a0);
        a0 = fmaf(qv.y, u.y, a0);
        a0 = fmaf(qv.z, u.z, a0);
        a0 = fmaf(qv.w, u.w, a0);
        a1 = fmaf(qv.x, w.x, a1);
        a1 = fmaf(qv.y, w.y, a1);
        a1 = fmaf(qv.z, w.z, a1);
        a1 = fmaf(qv.w, w.w, a1);
      }
      const bool v0 = ss < rows;
      const bool v1 = ss + 16 < rows;
      const float sc0 = v0 ? a0 * scale : kNegInf;
      const float sc1 = v1 ? a1 * scale : kNegInf;
      float mx = fmaxf(sc0, sc1);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      const float safe_m = m_new <= 0.5f * kNegInf ? 0.f : m_new;
      const float alpha = m_run <= 0.5f * kNegInf ? 0.f : expf(m_run - safe_m);
      const float p0 = v0 ? expf(sc0 - safe_m) : 0.f;
      const float p1 = v1 ? expf(sc1 - safe_m) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run = fmaf(l_run, alpha, sum);
      m_run = m_new;
      p_s[sh * kRows + ss] = p0;
      p_s[sh * kRows + ss + 16] = p1;
      if (ss == 0) alpha_s[sh] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ c over the tile (rows past `rows` hold zeros
    // and have p = 0).
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const float al = alpha_s[hc + TH * i];
#pragma unroll
      for (int j = 0; j < NK; ++j) acc[i][j] *= al;
    }
#pragma unroll 2
    for (int s = 0; s < kRows; s += 4) {
      float4 cv[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float* col = kv_s + s * Dp + kc + TK * j;
        cv[j] = make_float4(col[0], col[Dp], col[2 * Dp], col[3 * Dp]);
      }
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + (hc + TH * i) * kRows + s);
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          float a = acc[i][j];
          a = fmaf(pv.x, cv[j].x, a);
          a = fmaf(pv.y, cv[j].y, a);
          a = fmaf(pv.z, cv[j].z, a);
          a = fmaf(pv.w, cv[j].w, a);
          acc[i][j] = a;
        }
      }
    }
  }

  // The split's partial state.
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int h = h0 + hc + TH * i;
    if (h < H) {
      float* dst = part_acc + (((int64_t)b * H + h) * n_split + split) * R + kc;
#pragma unroll
      for (int j = 0; j < NK; ++j) dst[TK * j] = acc[i][j];
    }
  }
  if (ss == 0 && h0 + sh < H) {
    float* ml = part_ml + (((int64_t)b * H + h0 + sh) * n_split + split) * 2;
    ml[0] = m_run;
    ml[1] = l_run;
  }
}

// Merge the splits of one (request, head) by log-sum-exp: weight w_j =
// exp(m_j - max m), out = sum_j w_j acc_j / max(sum_j w_j l_j, 1e-30).
// Grid (H, B).
template <typename T>
__global__ void __launch_bounds__(128)
    mla_combine_kernel(int H, int R, int n_split, const float* __restrict__ part_acc,
                       const float* __restrict__ part_ml, T* __restrict__ out) {
  __shared__ float w_s[kMaxSplits];
  const int64_t bh = (int64_t)blockIdx.y * H + blockIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  float m = kNegInf;
  for (int j = 0; j < n_split; ++j) m = fmaxf(m, ml[2 * j]);
  const float safe_m = m <= 0.5f * kNegInf ? 0.f : m;
  for (int j = threadIdx.x; j < n_split; j += blockDim.x) {
    const float mj = ml[2 * j];
    w_s[j] = mj <= 0.5f * kNegInf ? 0.f : expf(mj - safe_m);
  }
  __syncthreads();
  float l = 0.f;
  for (int j = 0; j < n_split; ++j) l = fmaf(w_s[j], ml[2 * j + 1], l);
  const float denom = fmaxf(l, 1e-30f);
  const float* acc = part_acc + bh * n_split * R;
  for (int k = threadIdx.x; k < R; k += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < n_split; ++j) a = fmaf(w_s[j], acc[(int64_t)j * R + k], a);
    store_out(out + bh * R + k, a / denom);
  }
}

// --------------------------------------------------------------------------
// The tensor-core kernel (bfloat16).

constexpr int kTcHeads = 64;            // heads per block: wgmma's M
constexpr int kTcRows = 64;             // cache rows per tile: the scores' N
constexpr int kChunk = 64;              // columns per 128-byte swizzle chunk
constexpr int kChunkBytes = 64 * 128;   // one chunk of 64 rows (a tile's or Q's)
constexpr int kTcThreads = 384;         // two consumer warpgroups + the producer
constexpr int kSmemLimit = 232448;
constexpr int kMaxStages = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box {64 columns, 64 rows, 1 request} of a (B, rows, cols) tensor map
// into shared memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(b)
      : "memory");
}

// Generic-proxy stores to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand whose
// 8-row groups are 1024 bytes apart (SBO). `lbo` is the byte distance to the
// next 64-column chunk along the operand's N dimension for an MN-major
// operand, and unused for a K-major one. The swizzle atoms are 1024-byte
// aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// The byte offset of the 16-byte unit `u` (0..7) of row `r` in a
// 128-byte-swizzled chunk: what TMA's SWIZZLE_128B writes and wgmma reads.
__device__ __forceinline__ uint32_t sw128_offset(int r, int u) {
  return static_cast<uint32_t>(r * 128 + ((u ^ (r & 7)) << 4));
}

// A named barrier over the 256 consumer threads (id 0 is __syncthreads').
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 32, float32) = or += A (64 x 16, shared, K-major) . B (16 x 32,
// shared, K-major): one k-step of the scores of a warpgroup's 32 rows.
__device__ __forceinline__ void wgmma_scores(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x N, float32) += A (64 x 16, shared, K-major) . B (16 x N, shared,
// MN-major): one k-step of the context.
__device__ __forceinline__ void wgmma_context(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_context(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_context(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Chunks kc0 .. kc0 + n - 1 of a 64-head block's queries [q_lat | q_rope]
// into consecutive swizzled 64 x 64 chunks at dst, by the 256 consumer
// threads; heads past H and columns past R and RR are zero.
__device__ __forceinline__ void stage_queries(uint8_t* dst, int kc0, int n, int RC, int R, int RR,
                                              int H, int h0, int b,
                                              const __nv_bfloat16* __restrict__ q_lat,
                                              const __nv_bfloat16* __restrict__ q_rope, int tid) {
  for (int i = tid; i < kTcHeads * n * 16; i += 256) {
    const int h = i / (n * 16);
    const int kc = kc0 + (i / 16) % n;
    const int hu = i % 16;
    uint2 v = make_uint2(0u, 0u);
    if (h0 + h < H) {
      const int64_t bh = (int64_t)b * H + h0 + h;
      if (kc < RC) {
        const int col = kc * kChunk + hu * 4;
        if (col < R) v = __ldg(reinterpret_cast<const uint2*>(q_lat + bh * R + col));
      } else {
        const int col = (kc - RC) * kChunk + hu * 4;
        if (col < RR) v = __ldg(reinterpret_cast<const uint2*>(q_rope + bh * RR + col));
      }
    }
    *reinterpret_cast<uint2*>(dst + (kc - kc0) * kChunkBytes + sw128_offset(h, hu >> 1) +
                              (hu & 1) * 8) = v;
  }
}

// One split of one request's rows for 64 heads on the tensor cores: the
// unnormalised float32 context (R per head) and the running max m (natural
// units) and normaliser l, into part_acc (B, H, n_split, R) and part_ml
// (B, H, n_split, 2). Grid (ceil(H / 64), n_split, B), 384 threads; `stages`
// row tiles in the ring; the queries resident in shared memory when
// kQResident, else staged one chunk at a time for each tile's scores. map_c
// views cache_c as (B, n_valid, R); map_kr views cache_kr as (B, n_valid, RR)
// when kr_by_tma, else kr is staged by plain loads from cache_kr.
template <int R, bool kQResident>
__global__ void __launch_bounds__(kTcThreads, 1)
    mla_tc_kernel(const __grid_constant__ CUtensorMap map_c,
                  const __grid_constant__ CUtensorMap map_kr, int H, int S, int RR, int n_valid,
                  int chunk, int stages, int kr_by_tma, float scale_log2,
                  const __nv_bfloat16* __restrict__ q_lat,
                  const __nv_bfloat16* __restrict__ q_rope,
                  const __nv_bfloat16* __restrict__ cache_kr, float* __restrict__ part_acc,
                  float* __restrict__ part_ml) {
  constexpr int RC = R < kChunk ? 1 : R / kChunk;  // latent chunks of a row
  constexpr int NW = R >= 128 ? R / 2 : 64;        // context columns a consumer warpgroup owns
  const int RRC = (RR + kChunk - 1) / kChunk;      // rope chunks of a row
  const int KC = RC + RRC;
  const uint32_t tile_bytes = KC * kChunkBytes;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  uint8_t* q_ptr = smem_raw + (q_s - raw);
  const uint32_t tiles_s = q_s + (kQResident ? tile_bytes : kChunkBytes);
  const uint32_t p_s = tiles_s + stages * tile_bytes;  // the 64 x 64 bf16 P tile
  uint8_t* p_ptr = smem_raw + (p_s - raw);
  const uint32_t red_s = p_s + kChunkBytes;  // [2][64] floats: row maxima, then row sums
  const uint32_t bars = red_s + 512;         // full[stages], then empty[stages]

  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * kTcHeads;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int b = blockIdx.z;
  const int row_begin = split * chunk;
  const int row_end = min(row_begin + chunk, n_valid);
  const int n_tiles = (row_end - row_begin + kTcRows - 1) / kTcRows;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      // full: the TMA bytes plus one arrival (the issuing thread's), or all
      // 128 producer threads' when they store kr themselves; empty: one
      // arrival per consumer warp.
      mbar_init(bars + 8 * i, kr_by_tma ? 1 : 128);
      mbar_init(bars + 8 * (stages + i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - 256;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % stages;
      const int s0 = row_begin + t * kTcRows;
      const uint32_t dst = tiles_s + st * tile_bytes;
      const uint32_t full = bars + 8 * st;
      if (t >= stages) mbar_wait(bars + 8 * (stages + st), ((t / stages) & 1) ^ 1);
      if (pt == 0) {
        mbar_expect_tx(full, (RC + (kr_by_tma ? RRC : 0)) * kChunkBytes);
        for (int k = 0; k < RC; ++k) tma_load(dst + k * kChunkBytes, &map_c, full, k * kChunk, s0, b);
        if (kr_by_tma)
          for (int k = 0; k < RRC; ++k)
            tma_load(dst + (RC + k) * kChunkBytes, &map_kr, full, k * kChunk, s0, b);
      }
      if (!kr_by_tma) {
        // kr rows in 4-value pieces, zero past n_valid and past RR.
        uint8_t* tile = smem_raw + (dst - raw) + RC * kChunkBytes;
        for (int i = pt; i < kTcRows * RRC * 16; i += 128) {
          const int r = i / (RRC * 16);
          const int kc = (i / 16) % RRC;
          const int hu = i % 16;
          const int col = kc * kChunk + hu * 4;
          const int s = s0 + r;
          uint2 v = make_uint2(0u, 0u);
          if (s < n_valid && col < RR)
            v = __ldg(reinterpret_cast<const uint2*>(cache_kr + ((int64_t)b * S + s) * RR + col));
          *reinterpret_cast<uint2*>(tile + kc * kChunkBytes + sw128_offset(r, hu >> 1) +
                                    (hu & 1) * 8) = v;
        }
        fence_async_smem();
        mbar_arrive(full);
      } else if (pt == 0) {
        mbar_arrive(full);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;

  if (kQResident) {
    stage_queries(q_ptr, 0, KC, RC, R, RR, H, h0, b, q_lat, q_rope, tid);
    fence_async_smem();
    consumers_sync(1);
  }

  // Thread layout of a 64-row wgmma accumulator: rows r0 and r0 + 8, columns
  // 8j + 2·(lane % 4) + {0, 1} in registers 4j + {0, 1} (row r0) and
  // 4j + {2, 3} (row r0 + 8).
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int col0 = R >= 128 ? wg * NW : 0;  // this warpgroup's first context column
  const int rope_steps = (RR + 15) / 16;
  float* red = reinterpret_cast<float*>(smem_raw + (red_s - raw));  // [2][64]

  float o[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) o[i] = 0.f;
  float sc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % stages;
    const uint32_t tile = tiles_s + st * tile_bytes;
    mbar_wait(bars + 8 * st, (t / stages) & 1);

    // Scores of this warpgroup's 32 rows of the tile: K-major A (queries)
    // and B (rows 32·wg .., 4096 bytes into each chunk), 16 columns of K a
    // step, 32 bytes apart inside a swizzle chunk.
    if (kQResident) {
      wgmma_fence();
#pragma unroll
      for (int g = 0; g < R / 16; ++g) {
        const uint32_t off = (g >> 2) * kChunkBytes + (g & 3) * 32;
        wgmma_scores(sc, sw128_desc(q_s + off, 16), sw128_desc(tile + off + wg * 4096, 16), g > 0);
      }
      for (int g = 0; g < rope_steps; ++g) {
        const uint32_t off = (RC + (g >> 2)) * kChunkBytes + (g & 3) * 32;
        wgmma_scores(sc, sw128_desc(q_s + off, 16), sw128_desc(tile + off + wg * 4096, 16), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
    } else {
      // Rows too wide for resident queries: each chunk of the queries in
      // turn into one shared chunk, and its k-steps of the scores.
      for (int kc = 0; kc < KC; ++kc) {
        const int steps = kc < RC ? min(4, R / 16) : min(4, rope_steps - 4 * (kc - RC));
        stage_queries(q_ptr, kc, 1, RC, R, RR, H, h0, b, q_lat, q_rope, tid);
        fence_async_smem();
        consumers_sync(1);
        wgmma_fence();
        for (int g = 0; g < steps; ++g)
          wgmma_scores(sc, sw128_desc(q_s + g * 32, 16),
                       sw128_desc(tile + kc * kChunkBytes + g * 32 + wg * 4096, 16), kc + g > 0);
        wgmma_commit();
        wgmma_wait_all();
        consumers_sync(1);  // both warpgroups are done with the chunk
      }
    }

    // Online softmax in base 2 over the whole tile: each warpgroup's row
    // maxima of its 32 columns meet in shared memory, so both warpgroups
    // hold the same running max (and so the same alpha).
    const int lim = row_end - (row_begin + t * kTcRows) - 32 * wg;  // columns < lim attend
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = 8 * j + cq + (e & 1) < lim;
        const float v = valid ? sc[4 * j + e] * scale_log2 : kNegInf;
        sc[4 * j + e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if ((lane & 3) == 0) {
      red[wg * 64 + r0] = mx[0];
      red[wg * 64 + r0 + 8] = mx[1];
    }
    consumers_sync(2);
    float alpha[2], safe_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], fmaxf(mx[i], red[(1 - wg) * 64 + r0 + 8 * i]));
      safe_m[i] = m_new <= 0.5f * kNegInf ? 0.f : m_new;
      alpha[i] = m_run[i] <= 0.5f * kNegInf ? 0.f : exp2f(m_run[i] - safe_m[i]);
      m_run[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = 8 * j + cq + (e & 1) < lim;
        const float p = valid ? exp2f(sc[4 * j + e] - safe_m[e >> 1]) : 0.f;
        sc[4 * j + e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = fmaf(l_run[i], alpha[i], sum[i]);
    // This warpgroup's 32 columns of P, rounded to bf16, into the shared
    // 64 x 64 P tile (a K-major, 128-byte-swizzled A operand).
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const int col = 32 * wg + 8 * j + cq;
        *reinterpret_cast<uint32_t*>(p_ptr + sw128_offset(r, col >> 3) + (col & 7) * 2) =
            pack_bf16(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
      }
    fence_async_smem();
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    consumers_sync(3);  // both halves of P are in place

    // Context: O += P · c[:, col0 : col0 + NW], P as a K-major A (32 bytes
    // a step), the tile's latent chunks as an MN-major B: 16 rows (2 groups
    // of 8, 1024 bytes apart) a step, the next 64 columns one chunk
    // (kChunkBytes) further.
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_context(o, sw128_desc(p_s + k * 32, 16),
                    sw128_desc(tile + (col0 / kChunk) * kChunkBytes + k * 16 * 128, kChunkBytes));
    wgmma_commit();
    // Release the stage as soon as its context product is done, so that
    // the next load into it starts a whole iteration before it is needed.
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(bars + 8 * (stages + st));
  }

  // The split's partial state; each warpgroup summed l over its columns.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  if ((lane & 3) == 0) {
    red[wg * 64 + r0] = l_run[0];
    red[wg * 64 + r0 + 8] = l_run[1];
  }
  consumers_sync(2);
  const bool stores = R >= 128 || wg == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int h = h0 + r0 + 8 * i;
    if (h >= H) continue;
    const int64_t slot = ((int64_t)b * H + h) * n_split + split;
    if (stores) {
      float* dst = part_acc + slot * R;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = col0 + 8 * j + cq;
        if (col < R)
          *reinterpret_cast<float2*>(dst + col) = make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      }
    }
    if (wg == 0 && (lane & 3) == 0) {
      part_ml[slot * 2] = m_run[i] * kLn2;
      part_ml[slot * 2 + 1] = red[r0 + 8 * i] + red[64 + r0 + 8 * i];
    }
  }
}

template <int R>
int launch_core(int B, int H, int S, int RR, int n_valid, int n_split, int chunk, float scale,
                const float* q_lat, const float* q_rope, const float* cache_c,
                const float* cache_kr, float* part_acc, float* part_ml, float* out,
                cudaStream_t s) {
  const int Dp = padded_dim(R + RR);
  const size_t smem = (size_t)(kHeads * Dp + kRows * Dp + kHeads * kRows + kHeads) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mla_split_kernel<float, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mla_split_kernel<float, R>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kHeads - 1) / kHeads, n_split, B);
  mla_split_kernel<float, R><<<grid, kThreads, smem, s>>>(
      H, S, RR, n_valid, chunk, scale, q_lat, q_rope, cache_c, cache_kr, part_acc, part_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_combine_kernel<float><<<dim3(H, B), 128, 0, s>>>(H, R, n_split, part_acc, part_ml, out);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor (B, rows, cols) with row stride `cols` and request stride
// `S·cols`, read as boxes of 64 columns x 64 rows, 128-byte swizzled; the
// rows past `rows` and the columns past `cols` read as zeros.
bool encode_rows(CUtensorMap* map, const void* base, int B, int S, int rows, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)S * cols * 2};
  const cuuint32_t box[3] = {kChunk, kTcRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor-core kernel's shared memory: 1024 bytes of alignment slack, the
// queries (KC chunks when resident, else one), `stages` row tiles of KC
// chunks, the P tile, the row maxima (2 x 64 floats) and two barriers a
// stage. The ring takes as many stages as fit beside resident queries (at
// most kMaxStages); where not even one does, the queries are streamed.
struct TcLayout {
  int stages;
  bool q_resident;
  size_t bytes;
};

TcLayout tc_layout(int KC) {
  for (int i = 0; i < 2; ++i) {
    const bool q_resident = i == 0;
    const size_t fixed = 1024 + (size_t)(q_resident ? KC : 1) * kChunkBytes + kChunkBytes + 512;
    const size_t stage = (size_t)KC * kChunkBytes + 16;
    const size_t fit = fixed > (size_t)kSmemLimit ? 0 : (kSmemLimit - fixed) / stage;
    const int stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
    if (stages > 0) return {stages, q_resident, fixed + stages * stage};
  }
  return {0, false, 0};
}

template <int R, bool kQResident>
cudaError_t start_tc(dim3 grid, size_t smem, cudaStream_t s, const CUtensorMap& map_c,
                     const CUtensorMap& map_kr, int H, int S, int RR, int n_valid, int chunk,
                     int stages, int kr_by_tma, float scale_log2, const __nv_bfloat16* q_lat,
                     const __nv_bfloat16* q_rope, const __nv_bfloat16* cache_kr, float* part_acc,
                     float* part_ml) {
  const cudaError_t err = cudaFuncSetAttribute(
      mla_tc_kernel<R, kQResident>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mla_tc_kernel<R, kQResident><<<grid, kTcThreads, smem, s>>>(
      map_c, map_kr, H, S, RR, n_valid, chunk, stages, kr_by_tma, scale_log2, q_lat, q_rope,
      cache_kr, part_acc, part_ml);
  return cudaGetLastError();
}

template <int R>
int launch_tc(int B, int H, int S, int RR, int n_valid, int n_split, int chunk, float scale,
              const __nv_bfloat16* q_lat, const __nv_bfloat16* q_rope,
              const __nv_bfloat16* cache_c, const __nv_bfloat16* cache_kr, float* part_acc,
              float* part_ml, __nv_bfloat16* out, cudaStream_t s) {
  const TcLayout lay = tc_layout((R < kChunk ? 1 : R / kChunk) + (RR + kChunk - 1) / kChunk);
  if (lay.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lay.bytes;
  const int kr_by_tma = (2 * RR) % 16 == 0;
  CUtensorMap map_c, map_kr;
  memset(&map_kr, 0, sizeof(map_kr));
  if (!encode_rows(&map_c, cache_c, B, S, n_valid, R) ||
      (kr_by_tma && RR > 0 && !encode_rows(&map_kr, cache_kr, B, S, n_valid, RR)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H + kTcHeads - 1) / kTcHeads, n_split, B);
  const cudaError_t err =
      (lay.q_resident ? start_tc<R, true> : start_tc<R, false>)(
          grid, smem, s, map_c, map_kr, H, S, RR, n_valid, chunk, lay.stages, kr_by_tma,
          scale * kLog2e, q_lat, q_rope, cache_kr, part_acc, part_ml);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_combine_kernel<__nv_bfloat16><<<dim3(H, B), 128, 0, s>>>(H, R, n_split, part_acc,
                                                                part_ml, out);
  return static_cast<int>(cudaGetLastError());
}

bool bad_common(int B, int H, int S, int RR, int n_valid, int n_split, int chunk, int rows) {
  return B <= 0 || H <= 0 || n_valid <= 0 || n_valid > S || RR < 0 || RR % 4 || n_split <= 0 ||
         n_split > kMaxSplits || chunk <= 0 || chunk % rows ||
         (int64_t)(n_split - 1) * chunk >= n_valid;
}

}  // namespace

#define RUDDER_MLA_SWITCH_R(CALL)                         \
  switch (R) {                                            \
    case 32: return CALL(32);                             \
    case 64: return CALL(64);                             \
    case 128: return CALL(128);                           \
    case 256: return CALL(256);                           \
    case 512: return CALL(512);                           \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// out (B, H, R) = the latent context of q_lat (B, H, R) / q_rope (B, H, RR)
// over the rows 0..n_valid-1 of cache_c (B, S, R) / cache_kr (B, S, RR), on
// `stream`, float32, on the CUDA cores. The rows are cut into n_split splits
// of `chunk` rows (a multiple of 32, each split non-empty); part_acc
// (B, H, n_split, R) and part_ml (B, H, n_split, 2) are float32 scratch.
// Pointers are device pointers of contiguous tensors. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a shape the kernel
// does not take).
extern "C" int rudder_mla_flash_decode_f32(int B, int H, int S, int R, int RR, int n_valid,
                                           int n_split, int chunk, float scale,
                                           const void* q_lat, const void* q_rope,
                                           const void* cache_c, const void* cache_kr,
                                           void* part_acc, void* part_ml, void* out,
                                           void* stream) {
  if (bad_common(B, H, S, RR, n_valid, n_split, chunk, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
#define RUDDER_MLA_CORE(r)                                                                  \
  launch_core<r>(B, H, S, RR, n_valid, n_split, chunk, scale,                              \
                 static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),      \
                 static_cast<const float*>(cache_c), static_cast<const float*>(cache_kr), \
                 static_cast<float*>(part_acc), static_cast<float*>(part_ml),              \
                 static_cast<float*>(out), static_cast<cudaStream_t>(stream))
  RUDDER_MLA_SWITCH_R(RUDDER_MLA_CORE)
#undef RUDDER_MLA_CORE
}

// The same in bfloat16 on the tensor cores: chunk a multiple of 64. The
// base pointers of cache_c and cache_kr must be 16-byte aligned (TMA).
extern "C" int rudder_mla_flash_decode_bf16(int B, int H, int S, int R, int RR, int n_valid,
                                            int n_split, int chunk, float scale,
                                            const void* q_lat, const void* q_rope,
                                            const void* cache_c, const void* cache_kr,
                                            void* part_acc, void* part_ml, void* out,
                                            void* stream) {
  if (bad_common(B, H, S, RR, n_valid, n_split, chunk, kTcRows))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
#define RUDDER_MLA_TC(r)                                                                  \
  launch_tc<r>(B, H, S, RR, n_valid, n_split, chunk, scale,                              \
               static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_rope),        \
               static_cast<const bf16*>(cache_c), static_cast<const bf16*>(cache_kr),    \
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),              \
               static_cast<bf16*>(out), static_cast<cudaStream_t>(stream))
  RUDDER_MLA_SWITCH_R(RUDDER_MLA_TC)
#undef RUDDER_MLA_TC
}
