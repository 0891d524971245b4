// Kernel K3: the inverse-MTF in-chunk scan.
//
// Replaces bmh_tpu/ops/pallas_mtf.py imtf_chunks / _imtf_kernel.  Each
// chunk lane starts from the identity list Q = [0..255] and, for every code
// c of its chunk in order, emits y = Q[c] and moves that entry to the
// front.  Outputs the per-step ys (m, K) and each lane's final list q
// (256, K), which ops/mtf.py composes across chunks.
//
// What bounds it: operations, not bytes.  Bytes moved are 4 B in and 4 B
// out per code, but each step is a dependent read of the list followed by
// a shift of c entries, so a lane's work is the sum of its codes.
//
// What the design does about it: one thread per lane, each lane's list in
// shared memory as bytes laid out [position][lane] (64 lanes per block,
// 16 KiB), so y = Q[c] is one direct index and not the TPU's 256-wide
// one-hot sum.  The move-to-front shift touches only positions 0..c, and
// MTF codes of compressible data are mostly small.  Codes and ys are
// time-major, so a warp's loads and stores of one step are contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlphabet = 256;
constexpr int kLanes = 64;

__global__ void imtf_kernel(const int32_t* __restrict__ codes,
                            int32_t* __restrict__ ys,
                            int32_t* __restrict__ q, int m, int k) {
  __shared__ uint8_t list[kAlphabet * kLanes];
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kLanes + tid;
  for (int p = 0; p < kAlphabet; ++p) list[p * kLanes + tid] = static_cast<uint8_t>(p);
  if (lane >= k) return;
  for (int t = 0; t < m; ++t) {
    const int c = codes[static_cast<size_t>(t) * k + lane] & (kAlphabet - 1);
    const uint8_t y = list[c * kLanes + tid];
    for (int p = c; p > 0; --p) list[p * kLanes + tid] = list[(p - 1) * kLanes + tid];
    list[tid] = y;
    ys[static_cast<size_t>(t) * k + lane] = y;
  }
  for (int p = 0; p < kAlphabet; ++p)
    q[static_cast<size_t>(p) * k + lane] = list[p * kLanes + tid];
}

}  // namespace

extern "C" int bmh_imtf_chunks(const void* codes, void* ys, void* q, int m,
                               int k, void* stream) {
  const int blocks = (k + kLanes - 1) / kLanes;
  if (blocks > 0) {
    imtf_kernel<<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes), static_cast<int32_t*>(ys),
        static_cast<int32_t*>(q), m, k);
  }
  return static_cast<int>(cudaGetLastError());
}
