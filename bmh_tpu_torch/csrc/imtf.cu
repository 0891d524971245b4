// Kernel K3: the inverse-MTF in-chunk scan.
//
// Replaces bmh_tpu/ops/pallas_mtf.py imtf_chunks / _imtf_kernel.  Each
// chunk lane starts from the identity list Q = [0..255] and, for every code
// c of its chunk in order, emits y = Q[c] and moves that entry to the
// front.  Outputs the per-step ys (m, K) and each lane's final list q
// (256, K), which ops/mtf.py composes across chunks.
//
// What bounds it: neither bytes (4 B in and 4 B out per code) nor
// arithmetic, but a dependent chain: every non-zero code reads the list the
// code before it left behind, so a lane cannot finish before its non-zero
// codes times the latency of one step, and the call cannot finish before
// its densest lane.  While every lane is still at work the card pays for
// the instructions a step issues instead.
//
// What the design does about it:
//   * A warp per lane, the list in registers: thread i holds list bytes
//     8i..8i+7 in two 32-bit registers.  y = Q[c] is one byte permute in
//     every thread and one shuffle from thread c >> 3.  The move to the
//     front is one step for the whole warp whatever c is: every thread
//     takes the top byte of the thread below by one shuffle (thread 0 takes
//     y) and two byte permutes shift its eight bytes up by one, with
//     selectors that leave the bytes at list positions above c where they
//     are.  The chain through the list is permute, shuffle, select, permute;
//     all else depends on c alone.  K lanes are K warps: the whole card is
//     busy, and other warps' steps fill each step's latency.
//   * Codes in batches of 32, zeros skipped: each thread loads one code of
//     its lane's next 32 (the following batch is requested before the
//     current one is worked on), one ballot finds the non-zero codes, and
//     only those are steps.  A zero code leaves the list alone and emits
//     the front byte of that moment, which is the y of the last step before
//     it; each thread keeps the y of the latest step at or before its own
//     position and the warp stores the batch's 32 ys at once.  The batch's
//     codes go through shared memory into eight registers of every thread,
//     so a step's code is a constant byte of a register, not a shuffle.
//   * A batch with many non-zero codes takes all 32 as steps without a
//     branch (a zero code is a step that moves nothing), so that the
//     compiler can lift what depends on the codes alone over the steps and
//     a lane alone on its scheduler, as the densest lanes are at the end of
//     a call, waits for little but the chain.
//   * Four lanes a block: neighbouring lanes share the 32-byte sector a
//     code lies in, and small blocks spread dense neighbours over the SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlphabet = 256;
constexpr int kLanesPerBlock = 4;
constexpr int kBatch = 32;
// non-zero codes from which a batch takes every code as a step
constexpr int kDenseBatch = 20;
constexpr unsigned kFull = 0xffffffffu;
// Selectors of the two byte permutes that move a thread's eight list bytes
// up by one, in one word: the low half picks the new lo from {lo: 0..3,
// in: 4..7}, the high half the new hi from {hi: 0..3, lo: 4..7}.
constexpr uint32_t kMoveAll = 0x21072107u;   // every byte takes the byte below it
constexpr uint32_t kMoveNone = 0x32103210u;  // every byte stays

// One step for code c (the same in every thread of the warp) on this
// thread's list bytes (lo, hi); nibble0 = 4 - 32 tid.  Returns y = Q[c],
// repeated in all four bytes.
__device__ __forceinline__ uint32_t step(uint32_t c, uint32_t& lo, uint32_t& hi,
                                         int tid, int nibble0) {
  const uint32_t y = __shfl_sync(kFull, __byte_perm(lo, hi, (c & 7) * 0x1111u), c >> 3);
  uint32_t in = __shfl_up_sync(kFull, hi, 1);
  if (tid == 0) in = y;
  // one selector nibble per list byte: those at positions <= c move
  const int moving = min(max(4 * static_cast<int>(c) + nibble0, 0), 32);
  const uint32_t stay = __funnelshift_lc(0u, kFull, moving);
  const uint32_t sel = (kMoveNone & stay) | (kMoveAll & ~stay);
  const uint32_t new_lo = __byte_perm(lo, in, sel);
  hi = __byte_perm(hi, lo, sel >> 16);
  lo = new_lo;
  return y;
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
imtf_kernel(const int32_t* __restrict__ codes, int32_t* __restrict__ ys,
            int32_t* __restrict__ q, int m, int k) {
  __shared__ __align__(16) uint8_t batch_s[kLanesPerBlock][kBatch];
  const int tid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * kLanesPerBlock + warp;
  if (lane >= k) return;  // the whole warp leaves; no block-wide barrier below
  const int nibble0 = 4 - 32 * tid;
  // list bytes 8 tid .. 8 tid + 7, lowest position in the lowest byte
  uint32_t lo = 0x03020100u + 0x08080808u * tid;
  uint32_t hi = lo + 0x04040404u;
  uint32_t out = 0;  // Q[0] before the first step
  const int32_t* cp = codes + lane;
  int32_t* yp = ys + lane;
  int32_t next = tid < m ? cp[static_cast<size_t>(tid) * k] : 0;
  for (int t0 = 0; t0 < m; t0 += kBatch) {
    const int t = t0 + tid;
    const uint32_t cd = next & (kAlphabet - 1);
    next = t + kBatch < m ? cp[static_cast<size_t>(t + kBatch) * k] : 0;
    const uint32_t nz = __ballot_sync(kFull, cd != 0);  // the same in every thread
    out = __shfl_sync(kFull, out, 31);  // the front byte, in all four bytes
    if (nz != 0) {
      batch_s[warp][tid] = static_cast<uint8_t>(cd);
      __syncwarp();
      const uint4 c0 = *reinterpret_cast<const uint4*>(&batch_s[warp][0]);
      const uint4 c1 = *reinterpret_cast<const uint4*>(&batch_s[warp][16]);
      __syncwarp();
      const uint32_t packed[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      if (__popc(nz) >= kDenseBatch) {
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const uint32_t c = (packed[i >> 2] >> (8 * (i & 3))) & 0xffu;
          const uint32_t y = step(c, lo, hi, tid, nibble0);
          if (tid >= i) out = y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (!(nz >> i & 1)) continue;
          const uint32_t c = (packed[i >> 2] >> (8 * (i & 3))) & 0xffu;
          const uint32_t y = step(c, lo, hi, tid, nibble0);
          if (tid >= i) out = y;
        }
      }
    }
    if (t < m) yp[static_cast<size_t>(t) * k] = static_cast<int32_t>(out & 0xffu);
  }
  for (int b = 0; b < 8; ++b)
    q[static_cast<size_t>(8 * tid + b) * k + lane] =
        static_cast<int32_t>(((b < 4 ? lo : hi) >> (8 * (b & 3))) & 0xffu);
}

}  // namespace

extern "C" int bmh_imtf_chunks(const void* codes, void* ys, void* q, int m,
                               int k, void* stream) {
  const int blocks = (k + kLanesPerBlock - 1) / kLanesPerBlock;
  if (blocks > 0) {
    imtf_kernel<<<blocks, 32 * kLanesPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes), static_cast<int32_t*>(ys),
        static_cast<int32_t*>(q), m, k);
  }
  return static_cast<int>(cudaGetLastError());
}
