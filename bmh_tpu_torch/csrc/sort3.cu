// Kernel K5: bitonic sort of int32 (k1, k2, idx) triples, row by row.
//
// Replaces bmh_tpu/ops/pallas_sort.py sort3 / _sort_kernel, the Pallas
// bitonic network that holds a whole row in VMEM and exchanges partners by
// rolling the (S, 128) tile.  Each row of the (B, N) inputs (N a power of
// two in [1024, 2^18]) comes out ascending by the triple; with distinct
// triples that is the stable sort by (k1, k2).
//
// What bounds it: device-memory traffic.  A comparison sort's least work is
// one read and one write of the 12-byte triples; the network does
// log2(N) (log2(N) + 1) / 2 compare-exchange steps, far more than that.
//
// What the design does about it: a row does not fit one block's shared
// memory (2^17 triples are 1.5 MB), so the network is cut at a tile of
// T = 4096 triples, which does (48 KB: a 64-bit key and the idx):
//   * one shared-memory launch sorts every tile through all stages
//     k <= log2 T (tile directions alternate, so pairs of tiles form the
//     bitonic sequences of stage log2 T + 1);
//   * for each later stage k, one launch per distance 2^j >= T does that
//     step's compare-exchanges in device memory (one thread per pair), then
//     one shared-memory launch finishes every distance j < log2 T.
// So a row passes through device memory 1 + sum over k of (k - log2 T + 1)
// times instead of once per step.  (k1, k2) compare as one sign-biased
// 64-bit key, idx breaks ties.  Radix passes, TMA staging or one
// persistent block per SM are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogTile = 12;
constexpr int kThreads = 1024;

__device__ __forceinline__ uint64_t pack_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a) ^ 0x80000000u) << 32) |
         (static_cast<uint32_t>(b) ^ 0x80000000u);
}

__device__ __forceinline__ bool greater(uint64_t ka, int32_t ia, uint64_t kb,
                                        int32_t ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// One compare-exchange step at distance 2^j (j >= log2 T) of stage k, in
// device memory.  Thread t owns pair t: the element pair (lo, lo + 2^j) of
// row t / (N/2).  Ascending iff bit k of the row position is 0.
__global__ void sort3_global_step(int32_t* k1, int32_t* k2, int32_t* id,
                                  int log_n, int k, int j, long long pairs) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long i = t & ((1LL << (log_n - 1)) - 1);
  const long long base = (t >> (log_n - 1)) << log_n;
  const long long lo_e = ((i >> j) << (j + 1)) | (i & ((1LL << j) - 1));
  const long long lo = base + lo_e;
  const long long hi = lo + (1LL << j);
  const bool asc = ((lo_e >> k) & 1) == 0;
  const int32_t a1 = k1[lo], a2 = k2[lo], a3 = id[lo];
  const int32_t b1 = k1[hi], b2 = k2[hi], b3 = id[hi];
  if (greater(pack_key(a1, a2), a3, pack_key(b1, b2), b3) == asc) {
    k1[lo] = b1; k2[lo] = b2; id[lo] = b3;
    k1[hi] = a1; k2[hi] = a2; id[hi] = a3;
  }
}

// Stages k_from..k_to on tiles of 2^log_t triples held in shared memory,
// every distance j < min(k, log_t).  Reads `in*`, writes `out*` (they may
// be the same arrays: each block reads and writes only its own tile).
__global__ void sort3_shared(const int32_t* in1, const int32_t* in2,
                             const int32_t* in3, int32_t* out1, int32_t* out2,
                             int32_t* out3, int log_n, int log_t, int k_from,
                             int k_to) {
  extern __shared__ unsigned char smem[];
  const int tile = 1 << log_t;
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);
  int32_t* ix = reinterpret_cast<int32_t*>(key + tile);
  const long long base = static_cast<long long>(blockIdx.x) << log_t;
  const long long e0 = base & ((1LL << log_n) - 1);  // tile start within its row
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    key[x] = pack_key(in1[base + x], in2[base + x]);
    ix[x] = in3[base + x];
  }
  __syncthreads();
  for (int k = k_from; k <= k_to; ++k) {
    for (int j = min(k, log_t) - 1; j >= 0; --j) {
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int lo = ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
        const int hi = lo | (1 << j);
        const bool asc = (((e0 + lo) >> k) & 1) == 0;
        const uint64_t ka = key[lo], kb = key[hi];
        const int32_t ia = ix[lo], ib = ix[hi];
        if (greater(ka, ia, kb, ib) == asc) {
          key[lo] = kb; ix[lo] = ib;
          key[hi] = ka; ix[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    out1[base + x] = static_cast<int32_t>(static_cast<uint32_t>(key[x] >> 32) ^ 0x80000000u);
    out2[base + x] = static_cast<int32_t>(static_cast<uint32_t>(key[x]) ^ 0x80000000u);
    out3[base + x] = ix[x];
  }
}

}  // namespace

// Sorts each of the b rows of 2^log_n triples from (k1, k2, id) into
// (o1, o2, o3).  Returns cudaGetLastError() after the launches.
extern "C" int bmh_sort3(const void* k1, const void* k2, const void* id,
                         void* o1, void* o2, void* o3, int b, int log_n,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* p1 = static_cast<int32_t*>(o1);
  auto* p2 = static_cast<int32_t*>(o2);
  auto* p3 = static_cast<int32_t*>(o3);
  const int log_t = log_n < kLogTile ? log_n : kLogTile;
  const int tile = 1 << log_t;
  const long long total = static_cast<long long>(b) << log_n;
  const int tiles = static_cast<int>(total >> log_t);
  const int threads = tile / 2 < kThreads ? tile / 2 : kThreads;
  const size_t smem = static_cast<size_t>(tile) * (sizeof(uint64_t) + sizeof(int32_t));
  if (tiles == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      sort3_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sort3_shared<<<tiles, threads, smem, s>>>(
      static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2),
      static_cast<const int32_t*>(id), p1, p2, p3, log_n, log_t, 1, log_t);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long pairs = total / 2;
  const int step_threads = 256;
  const int step_blocks = static_cast<int>((pairs + step_threads - 1) / step_threads);
  for (int k = log_t + 1; k <= log_n; ++k) {
    for (int j = k - 1; j >= log_t; --j) {
      sort3_global_step<<<step_blocks, step_threads, 0, s>>>(p1, p2, p3, log_n, k, j, pairs);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    sort3_shared<<<tiles, threads, smem, s>>>(p1, p2, p3, p1, p2, p3, log_n, log_t, k, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
