// Kernel K7: the move-to-front forward of a compress batch.
//
// Replaces no TPU kernel.  bmh_tpu's mtf_forward (bmh_tpu/ops/mtf.py) is
// jnp ops: each 128-byte chunk is extended with its incoming list and every
// code is counted as a windowed compare over the (128, 384) extended chunk.
// The port's plain version (ops/mtf.py mtf_forward_plain) writes the same
// tensors out: about 49k int64 compare-and-adds for every 128 input bytes,
// plus sorts, cummax scans and argsorts of (B, k, 256) int64 tables, about
// 31 ms for a 32 x 128 KiB batch on an H100.  This kernel gives the same
// codes: the standard MTF of each row from the identity list, zero past the
// row's n.  Codes do not depend on how a row is cut into lanes.
//
// What bounds it: by bytes, n in and n out a row (8.4 MB for 32 x 128 KiB:
// 2.5 us at 3.35 TB/s); in fact a dependent chain.  Within a lane every
// code reads the list the code before it left behind, so a lane cannot
// finish before its steps (codes whose symbol is not already at the front)
// times the latency of one step, and while every lane is at work the card
// pays for the instructions a step issues.
//
// The design, three passes in one call on the caller's stream:
//   1. lane_last: a warp per lane (a run of lane_len bytes of a row) finds
//      the last position of each symbol inside the lane, up to the row's n.
//      The 32 bytes of a round are grouped by symbol (match_any) and the
//      highest thread of a group writes its position to shared memory, so
//      the runs of a BWT last column cost no atomics.
//   2. incoming: a thread per (row, symbol) turns those tables into the
//      exclusive running max over the row's lanes, in place: the symbol's
//      last position before each lane starts (-1: not yet seen).  Loads go
//      16 lanes ahead of the max.
//   3. forward: a warp per lane builds the lane's incoming list, recency
//      first: a seen symbol's key is its last position, an unseen symbol s
//      keys -1 - s (behind every seen one, in the identity order), and its
//      list position is the number of larger keys (each thread counts for
//      its 8 symbols against all 256 keys in shared memory).  Then K3's
//      list in registers, run forwards: thread i holds list bytes 8i..8i+7
//      in two words.  A step for symbol x compares x with every list byte
//      at once (a zero-byte test of the words xor x), one ballot tells each
//      thread whether x lies above, inside or below its eight bytes, and
//      K3's two byte permutes move the bytes at positions up to x's up by
//      one, with x coming in at the front.  The thread that holds x writes
//      its position, the code, to shared memory.  The step's chain is the
//      compare, the ballot and the permutes; the shuffle that brings each
//      thread the top byte of the thread below runs beside it.
//   Bytes equal to the byte before them (the front of the list; for a
//   lane's first byte, its incoming list's front) are code 0 and leave the
//   list alone: a BWT last column is full of such runs.  As in K3, a round
//   of 32 bytes finds them with one ballot and runs only the others as
//   steps, unless 20 or more are steps, when it runs all 32 without a
//   branch (x at the front is a step that moves nothing and writes 0).
//   Lanes wholly past a row's n write zeros and do nothing else, so the
//   n = 1 dummy rows of a padded batch and the padding of short rows cost
//   their stores alone.
// Nothing here allocates or waits: the wrapper passes the (rows * lanes,
// 256) int32 scratch of passes 1-2 and the output, so a call can sit
// inside a captured CUDA graph.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlphabet = 256;
constexpr int kLanesPerBlock = 4;
constexpr int kBatch = 32;
// steps from which a round takes every byte as a step
constexpr int kDenseBatch = 20;
// lanes whose tables pass 2 loads before it takes their max
constexpr int kScanAhead = 16;
constexpr unsigned kFull = 0xffffffffu;
// K3's selectors of the two byte permutes that move a thread's eight list
// bytes up by one: the low half picks the new lo from {lo: 0..3, in: 4..7},
// the high half the new hi from {hi: 0..3, lo: 4..7}.
constexpr uint32_t kMoveAll = 0x21072107u;   // every byte takes the byte below it
constexpr uint32_t kMoveNone = 0x32103210u;  // every byte stays

// The row's true length, clamped to [0, nmax].
__device__ __forceinline__ int row_len(const int64_t* n, int row, int nmax) {
  const int64_t v = n[row];
  return static_cast<int>(v < 0 ? 0 : (v > nmax ? nmax : v));
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
lane_last_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ n,
                 int32_t* __restrict__ last, int nmax, int lane_len, int lanes,
                 int rows) {
  __shared__ int32_t last_s[kLanesPerBlock][kAlphabet];
  const int tid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * kLanesPerBlock + warp;
  if (lane >= rows * lanes) return;  // whole warps leave; no block barrier below
  const int row = lane / lanes;
  const int start = (lane - row * lanes) * lane_len;
  const int end = min(start + lane_len, row_len(n, row, nmax));
  if (end <= start) return;  // pass 2 reads no lane past the row's n
  for (int s = tid; s < kAlphabet; s += 32) last_s[warp][s] = -1;
  __syncwarp();
  const uint8_t* in = data + static_cast<size_t>(row) * nmax;
  for (int p0 = start; p0 < end; p0 += 32) {
    const int p = p0 + tid;
    const bool valid = p < end;
    const uint32_t x = valid ? in[p] : 0u;
    const uint32_t group = __match_any_sync(kFull, valid ? x : kAlphabet);
    // the highest thread of its symbol's group holds the round's last position
    if (valid && (group >> tid) == 1u) last_s[warp][x] = p;
    __syncwarp();
  }
  int32_t* out = last + static_cast<size_t>(lane) * kAlphabet;
  for (int s = tid; s < kAlphabet; s += 32) out[s] = last_s[warp][s];
}

__global__ void __launch_bounds__(kAlphabet)
incoming_kernel(int32_t* __restrict__ last, const int64_t* __restrict__ n, int nmax,
                int lane_len, int lanes) {
  const int row = blockIdx.x;
  const int s = threadIdx.x;
  // the lanes that hold some of the row's bytes
  const int active = (row_len(n, row, nmax) + lane_len - 1) / lane_len;
  int32_t* p = last + static_cast<size_t>(row) * lanes * kAlphabet + s;
  int32_t run = -1;
  int j = 0;
  for (; j + kScanAhead <= active; j += kScanAhead) {
    int32_t v[kScanAhead];
#pragma unroll
    for (int i = 0; i < kScanAhead; ++i) v[i] = p[static_cast<size_t>(j + i) * kAlphabet];
#pragma unroll
    for (int i = 0; i < kScanAhead; ++i) {
      p[static_cast<size_t>(j + i) * kAlphabet] = run;
      run = max(run, v[i]);
    }
  }
  for (; j < active; ++j) {
    const int32_t v = p[static_cast<size_t>(j) * kAlphabet];
    p[static_cast<size_t>(j) * kAlphabet] = run;
    run = max(run, v);
  }
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
forward_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ n,
               const int32_t* __restrict__ incoming, uint8_t* __restrict__ codes,
               int nmax, int lane_len, int lanes, int rows) {
  __shared__ __align__(16) int32_t key_s[kLanesPerBlock][kAlphabet];
  __shared__ __align__(16) uint8_t list_s[kLanesPerBlock][kAlphabet];
  __shared__ __align__(16) uint8_t batch_s[kLanesPerBlock][kBatch];
  __shared__ uint8_t code_s[kLanesPerBlock][kBatch];
  const int tid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * kLanesPerBlock + warp;
  if (lane >= rows * lanes) return;  // whole warps leave; no block barrier below
  const int row = lane / lanes;
  const int start = (lane - row * lanes) * lane_len;
  const int lane_end = min(start + lane_len, nmax);
  const int end = min(lane_end, row_len(n, row, nmax));
  uint8_t* out = codes + static_cast<size_t>(row) * nmax;
  if (end <= start) {
    for (int p = start + tid; p < lane_end; p += 32) out[p] = 0;
    return;
  }

  // the incoming list: symbol s at the number of keys larger than its own
  const int4* ip = reinterpret_cast<const int4*>(incoming + static_cast<size_t>(lane) * kAlphabet);
  const int4 a = ip[2 * tid], b = ip[2 * tid + 1];
  int32_t key[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (key[q] < 0) key[q] = -1 - (8 * tid + q);
    key_s[warp][8 * tid + q] = key[q];
  }
  __syncwarp();
  int rank[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int t = 0; t < kAlphabet; t += 4) {
    const int4 k4 = *reinterpret_cast<const int4*>(&key_s[warp][t]);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      rank[q] += (k4.x > key[q]) + (k4.y > key[q]) + (k4.z > key[q]) + (k4.w > key[q]);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) list_s[warp][rank[q]] = static_cast<uint8_t>(8 * tid + q);
  __syncwarp();
  // list bytes 8 tid .. 8 tid + 7, lowest position in the lowest byte
  uint32_t lo = *reinterpret_cast<const uint32_t*>(&list_s[warp][8 * tid]);
  uint32_t hi = *reinterpret_cast<const uint32_t*>(&list_s[warp][8 * tid + 4]);
  uint32_t front = list_s[warp][0];

  const uint8_t* in = data + static_cast<size_t>(row) * nmax;
  uint32_t next = start + tid < end ? in[start + tid] : 0u;
  for (int t0 = start; t0 < end; t0 += kBatch) {
    const int p = t0 + tid;
    const uint32_t x = next;
    next = p + kBatch < end ? in[p + kBatch] : 0u;
    uint32_t before = __shfl_up_sync(kFull, x, 1);
    if (tid == 0) before = front;
    front = __shfl_sync(kFull, x, 31);
    const uint32_t steps = __ballot_sync(kFull, p < end && x != before);
    uint32_t code = 0;
    if (steps != 0) {
      batch_s[warp][tid] = static_cast<uint8_t>(x);
      code_s[warp][tid] = 0;
      __syncwarp();
      const uint4 c0 = *reinterpret_cast<const uint4*>(&batch_s[warp][0]);
      const uint4 c1 = *reinterpret_cast<const uint4*>(&batch_s[warp][16]);
      const uint32_t packed[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      // one step for byte i of the round (the same x in every thread)
      auto step = [&](int i) {
        const uint32_t xx = ((packed[i >> 2] >> (8 * (i & 3))) & 0xffu) * 0x01010101u;
        const uint32_t dlo = lo ^ xx, dhi = hi ^ xx;
        // a high bit at each zero byte of d (exact up to the lowest one)
        const uint32_t zlo = (dlo - 0x01010101u) & ~dlo & 0x80808080u;
        const uint32_t zhi = (dhi - 0x01010101u) & ~dhi & 0x80808080u;
        const bool mine = (zlo | zhi) != 0;
        const uint32_t holder = __ballot_sync(kFull, mine);
        // this thread's bytes that move: up to x's in the holder, all
        // eight below it, none above
        const int moved = mine ? (zlo ? __ffs(zlo) >> 3 : 4 + (__ffs(zhi) >> 3))
                               : ((holder >> tid) != 0u ? 8 : 0);
        uint32_t inb = __shfl_up_sync(kFull, hi, 1);
        if (tid == 0) inb = xx;
        const uint32_t stay = __funnelshift_lc(0u, kFull, 4 * moved);
        const uint32_t sel = (kMoveNone & stay) | (kMoveAll & ~stay);
        const uint32_t new_lo = __byte_perm(lo, inb, sel);
        hi = __byte_perm(hi, lo, sel >> 16);
        lo = new_lo;
        if (mine) code_s[warp][i] = static_cast<uint8_t>(8 * tid + moved - 1);
      };
      if (__popc(steps) >= kDenseBatch) {
#pragma unroll
        for (int i = 0; i < kBatch; ++i) step(i);
      } else {
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (steps >> i & 1) step(i);
      }
      __syncwarp();
      code = code_s[warp][tid];
      __syncwarp();
    }
    if (p < end) out[p] = static_cast<uint8_t>(code);
  }
  for (int p = end + tid; p < lane_end; p += 32) out[p] = 0;
}

}  // namespace

extern "C" int bmh_mtf_forward(const void* data, const void* n, void* scratch,
                               void* codes, int rows, int nmax, int lane_len, int lanes,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows * lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  if (blocks > 0) {
    const uint8_t* d = static_cast<const uint8_t*>(data);
    const int64_t* nn = static_cast<const int64_t*>(n);
    int32_t* last = static_cast<int32_t*>(scratch);
    lane_last_kernel<<<blocks, 32 * kLanesPerBlock, 0, s>>>(d, nn, last, nmax, lane_len,
                                                            lanes, rows);
    incoming_kernel<<<rows, kAlphabet, 0, s>>>(last, nn, nmax, lane_len, lanes);
    forward_kernel<<<blocks, 32 * kLanesPerBlock, 0, s>>>(d, nn, last,
                                                          static_cast<uint8_t*>(codes),
                                                          nmax, lane_len, lanes, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
