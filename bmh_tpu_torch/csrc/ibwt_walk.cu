// Kernel K4: the checkpointed inverse-BWT LF walk.
//
// Replaces bmh_tpu/ops/pallas_ibwt.py ibwt_walk / _ibwt_kernel (which
// Mosaic refused, so bmh_tpu runs the walk as the XLA scan in
// ops/bwt.py bwt_inverse_cursors).  Each of the k cursors of a block walks
// `steps` LF steps over the packed table entry = (byte << 23) | next_row
// and emits one byte per step.
//
// What bounds it: the latency of dependent loads.  Step s+1's address is
// step s's loaded value, so a cursor issues one load at a time; the only
// parallelism is across cursors (B*k = 1024 for a 32-block batch of
// 128 KiB blocks).  Bytes moved are small (each table entry read about
// once, one byte written per step).
//
// What the design does about it: one thread per cursor, threads spread
// one warp per block over many SMs so each SM's load queue holds a few
// independent chains.  A 128 KiB block's table is 512 KiB, more than one
// block's 227 KB of shared memory, so it is not staged there; a 32-block
// batch's tables (16 MiB) fit the 50 MB L2, so after first touch every
// dependent load is an L2 hit rather than a device-memory round trip.
// Loads go through the read-only path (__ldg).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLfMask = (1u << 23) - 1;

__global__ void ibwt_walk_kernel(const uint32_t* __restrict__ table,
                                 const int32_t* __restrict__ starts,
                                 uint8_t* __restrict__ out,
                                 int nmax, int k, int steps, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const uint32_t* t = table + static_cast<size_t>(i / k) * nmax;
  uint8_t* o = out + static_cast<size_t>(i) * steps;
  uint32_t r = static_cast<uint32_t>(starts[i]);
  for (int s = 0; s < steps; ++s) {
    const uint32_t g = __ldg(t + r);
    o[s] = static_cast<uint8_t>(g >> 23);
    r = g & kLfMask;
  }
}

}  // namespace

extern "C" int bmh_ibwt_walk(const void* table, const void* starts, void* out,
                             int b, int nmax, int k, int steps, void* stream) {
  const int total = b * k;
  const int threads = 32;
  const int blocks = (total + threads - 1) / threads;
  if (blocks > 0) {
    ibwt_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(table), static_cast<const int32_t*>(starts),
        static_cast<uint8_t*>(out), nmax, k, steps, total);
  }
  return static_cast<int>(cudaGetLastError());
}
