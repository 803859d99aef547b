// frontier_unique.cu — fused frontier dedup of the staged pipeline's
// sampler plane, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/frontier_unique.py::frontier_unique_batch
// (int32 keys) and ::frontier_unique_batch_wide (the same function over
// (hi, lo) int32 word planes of 64-bit keys). Here both are one kernel,
// a template over the key type: int32_t, and int64_t, which CUDA carries
// natively, so no word planes. Computes, for row-sorted keys (P, M) and
// remote flags (P, M):
//   first[p, i]  = key[p, i] != (i > 0 ? key[p, i - 1] : -1)
//   remote[p, i] = first[p, i] && is_remote[p, i]
//   ucount[p] = sum_i first[p, i],  rcount[p] = sum_i remote[p, i]
// Spec: repro_torch/kernels/ref.py::frontier_unique_batch.
//
// What bounds it on this card: bytes. Each position reads its key (and
// its left neighbour's, a cache hit) and its flag and writes two bool
// masks: 4-8 + 1 + 2 bytes per position, a few integer operations.
//
// What the design does about it: a 2-D grid, (ceil(M / 256), P), one
// thread per position; neighbouring threads read neighbouring keys, so
// every load and store is coalesced. The Pallas wrapper's materialised
// prev array and its padding to (64, 128) tiles are gone: a thread reads
// key[i - 1] itself and the ragged edge is masked. The per-PE counts
// are one __syncthreads_count per block and one atomicAdd per block and
// count into the (P,) int32 outputs, which the wrapper zeroes; integer
// sums are exact in any order. Bool outputs are written as 0/1 bytes,
// which is torch.bool's storage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Key>
__global__ void __launch_bounds__(kThreads)
    frontier_unique_kernel(int64_t M, const Key* __restrict__ keys,
                           const uint8_t* __restrict__ is_remote,
                           uint8_t* __restrict__ first,
                           uint8_t* __restrict__ remote,
                           int32_t* __restrict__ ucount,
                           int32_t* __restrict__ rcount) {
  const int p = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t at = (int64_t)p * M + i;
  int f = 0;
  int r = 0;
  if (i < M) {
    const Key prev = i > 0 ? keys[at - 1] : static_cast<Key>(-1);
    f = keys[at] != prev;
    r = f && is_remote[at] != 0;
    first[at] = static_cast<uint8_t>(f);
    remote[at] = static_cast<uint8_t>(r);
  }
  const int nf = __syncthreads_count(f);
  const int nr = __syncthreads_count(r);
  if (threadIdx.x == 0) {
    if (nf) atomicAdd(ucount + p, nf);
    if (nr) atomicAdd(rcount + p, nr);
  }
}

template <typename Key>
int launch(int P, int64_t M, const Key* keys, const uint8_t* is_remote,
           uint8_t* first, uint8_t* remote, int32_t* ucount, int32_t* rcount,
           void* stream) {
  if (P <= 0 || M <= 0) return 0;
  const int64_t tiles = (M + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(P));
  frontier_unique_kernel<Key>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          M, keys, is_remote, first, remote, ucount, rcount);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// first, remote (P, M) uint8 and ucount, rcount (P,) int32 (zeroed by the
// caller) from row-sorted int32 keys and uint8 remote flags, on `stream`.
// Pointers are device pointers of contiguous tensors. Returns the
// cudaError_t of the launch, or 0.
extern "C" int rudder_frontier_unique(int P, int64_t M, const int32_t* keys,
                                      const uint8_t* is_remote,
                                      uint8_t* first, uint8_t* remote,
                                      int32_t* ucount, int32_t* rcount,
                                      void* stream) {
  return launch<int32_t>(P, M, keys, is_remote, first, remote, ucount, rcount,
                         stream);
}

// The same over int64 keys (the reference's wide twin).
extern "C" int rudder_frontier_unique_wide(int P, int64_t M,
                                           const int64_t* keys,
                                           const uint8_t* is_remote,
                                           uint8_t* first, uint8_t* remote,
                                           int32_t* ucount, int32_t* rcount,
                                           void* stream) {
  return launch<int64_t>(P, M, keys, is_remote, first, remote, ucount, rcount,
                         stream);
}
