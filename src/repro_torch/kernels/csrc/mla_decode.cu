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
// 3e-2 in bfloat16): the online softmax sums in another order.
//
// What bounds it on this card: every head of a request reads the same cache
// rows (MLA is multi-query attention in latent space), so the bytes are one
// read of the rows 0..pos of c and kr plus the queries and the output, and
// the operations are 2·H·(R + RR) per row for the scores and 2·H·R for the
// context. At 128 heads that is ~2·128 operations per cache element, near
// the card's ridge (~295 bf16 tensor-core operations per byte): both bounds
// are close. This first kernel does its products on the CUDA cores in
// float32 (fmaf), so it runs well above the tensor-core bound; wgmma with
// TMA-fed tiles is the later step.
//
// What the design does about it:
// * A block owns 16 heads of one request and one split of the rows. It
//   stages a tile of 32 rows of [c | kr] in shared memory (as float32) and
//   uses it for all 16 heads: no row is read from device memory once per
//   head. The heads' queries stay in shared memory for the block's life.
//   The blocks of one request's head groups are neighbours in the grid, so
//   the rows they share are L2 hits.
// * Only rows 0..pos are read: the masked tail contributes exact zeros, and
//   the grid covers pos + 1 rows, not S.
// * Split over S (flash-decoding), chosen because the serving batch is
//   small: B = 4 requests × 8 head groups is 32 blocks for 132 SMs. The
//   wrapper picks the number of splits so that the grid has about two
//   blocks per SM (one split when B·H/16 already fills the card, as at
//   batch 128). Each split keeps its own running max m, normaliser l and
//   float32 accumulator, written unnormalised to scratch; a second small
//   kernel in the same call merges the splits by log-sum-exp.
// * No TPU idiom is carried over: no sequential grid with scratch carried
//   across steps (a loop over tiles inside the block does that), no padding
//   of S to 256 (the last tile is masked), and pos arrives as a kernel
//   argument, not by scalar prefetch.
// * Numerics as the Pallas kernel: a split or tile that has no row yet
//   (running max still NEG_INF) gets alpha = 0 and exact-zero
//   probabilities, never exp(NEG_INF - NEG_INF); expf, not __expf; the
//   output is acc / max(l, 1e-30) rounded to nearest. The products use
//   fmaf explicitly, so -fmad=false (set for every source of the port)
//   does not split them.
//
// Shapes it takes (the wrapper checks them): R in {32, 64, 128, 256, 512}
// (DeepSeek-V3's kv_lora_rank is 512), RR a multiple of 4, any H, B and S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Four bfloat16 values widened exactly to float32 (the 16 bits become the
// high half of each float).
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
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

template <typename T, int R>
int launch(int B, int H, int S, int RR, int n_valid, int n_split, int chunk,
           float scale, const void* q_lat, const void* q_rope, const void* cache_c,
           const void* cache_kr, float* part_acc, float* part_ml, void* out,
           cudaStream_t s) {
  const int Dp = padded_dim(R + RR);
  const size_t smem = (size_t)(kHeads * Dp + kRows * Dp + kHeads * kRows + kHeads) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mla_split_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mla_split_kernel<T, R>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kHeads - 1) / kHeads, n_split, B);
  mla_split_kernel<T, R><<<grid, kThreads, smem, s>>>(
      H, S, RR, n_valid, chunk, scale, static_cast<const T*>(q_lat),
      static_cast<const T*>(q_rope), static_cast<const T*>(cache_c),
      static_cast<const T*>(cache_kr), part_acc, part_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_combine_kernel<T><<<dim3(H, B), 128, 0, s>>>(H, R, n_split, part_acc, part_ml,
                                                    static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_r(int B, int H, int S, int R, int RR, int n_valid, int n_split, int chunk,
             float scale, const void* q_lat, const void* q_rope, const void* cache_c,
             const void* cache_kr, float* part_acc, float* part_ml, void* out,
             cudaStream_t s) {
#define RUDDER_MLA_R(r)                                                              \
  case r:                                                                            \
    return launch<T, r>(B, H, S, RR, n_valid, n_split, chunk, scale, q_lat, q_rope, \
                        cache_c, cache_kr, part_acc, part_ml, out, s);
  switch (R) {
    RUDDER_MLA_R(32)
    RUDDER_MLA_R(64)
    RUDDER_MLA_R(128)
    RUDDER_MLA_R(256)
    RUDDER_MLA_R(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RUDDER_MLA_R
}

}  // namespace

// out (B, H, R) = the latent context of q_lat (B, H, R) / q_rope (B, H, RR)
// over the rows 0..n_valid-1 of cache_c (B, S, R) / cache_kr (B, S, RR), on
// `stream`. The rows are cut into n_split splits of `chunk` rows (a multiple
// of 32, each split non-empty); part_acc (B, H, n_split, R) and part_ml
// (B, H, n_split, 2) are float32 scratch. `bf16` selects bfloat16 inputs and
// output (else float32). Pointers are device pointers of contiguous tensors.
// Returns the cudaError_t of the launches (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int rudder_mla_flash_decode(int B, int H, int S, int R, int RR, int n_valid,
                                       int n_split, int chunk, float scale, int bf16,
                                       const void* q_lat, const void* q_rope,
                                       const void* cache_c, const void* cache_kr,
                                       void* part_acc, void* part_ml, void* out,
                                       void* stream) {
  if (B <= 0 || H <= 0 || n_valid <= 0 || n_valid > S || RR < 0 || RR % 4 ||
      n_split <= 0 || n_split > kMaxSplits || chunk <= 0 || chunk % kRows ||
      (int64_t)(n_split - 1) * chunk >= n_valid)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  return bf16 ? launch_r<__nv_bfloat16>(B, H, S, R, RR, n_valid, n_split, chunk, scale,
                                        q_lat, q_rope, cache_c, cache_kr, pa, pm, out, s)
              : launch_r<float>(B, H, S, R, RR, n_valid, n_split, chunk, scale, q_lat,
                                q_rope, cache_c, cache_kr, pa, pm, out, s);
}
