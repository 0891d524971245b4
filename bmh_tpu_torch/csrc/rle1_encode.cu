// Kernel K8: RLE1, the pre-BWT run collapse, of a compress batch.
//
// Replaces no TPU kernel.  bmh_tpu runs RLE1 on the host, block by block,
// before the first dispatch (csrc/bmh_io.cpp bmh_rle1_encode, a byte-by-byte
// scan), and so did the port: about a third of a text stream's compress
// call, with the card idle all through it, for an encoding that text blocks
// throw away (none of them shrinks).  This kernel runs it on the card,
// inside the compress program, and gives what the host staged: each row's
// encoding, zero past it, where the encoding is strictly shorter than the
// row, and the row itself, zero past n, elsewhere; and the rows' lengths.
//
// The encoding: a run of L >= 4 equal bytes v becomes groups "v v v v
// (take - 4)", take = min(L, 255) while L >= 4, and a remainder below 4 stays
// literal.  Every input byte emits by its offset w = (i - run start) % 255
// alone: one byte (itself) at w < 3, two at w = 3 (itself and the group's
// count), none at w >= 4.  So the output offsets need the run starts only,
// a running max, and the group's count is written by its last byte (the
// run's last, which the next byte tells, or w = 254) where the w = 3 byte's
// pair ends: one byte after its own offset at w = 3, one before at w > 3.
//
// What bounds it: bytes.  The least a call moves is each row's n bytes read
// and the (rows, nmax) output written once, 8.4 MB for 32 x 128 KiB (2.5 us
// at 3.35 TB/s).  It reads the n bytes twice and the carries a few times.
//
// The design, three passes in one call on the caller's stream, lanes of
// 1024 bytes of a row, a warp per lane, 32 bytes a round:
//   1. lane_counts: the lane's first and last run start (its boundaries:
//      position 0 and each byte unlike the one before), and the bytes that
//      its positions from its first boundary on emit.  A boundary's round
//      position is one ballot; each byte's run start, the highest boundary
//      at or below it in the round or the carry from the round before.
//   2. row_offsets: a block per row.  Each lane's carried run start is the
//      running max of the last boundaries of the lanes before it; the bytes
//      its head (the positions before its first boundary, which continue
//      that run) emit follow from the carry in closed form; an exclusive
//      sum of the lanes' counts gives their output offsets and the row's
//      encoded length m.  The row's length out is m where m < n, else n.
//   3. lane_emit: a row that shrinks is written lane by lane: each byte's
//      offset is the lane's plus a warp scan of the round's emits; each lane
//      also zeroes its share of [m, nmax).  Any other row is copied, zero
//      past n.  Lanes past a row's n do only their share of the zeros or
//      the copy, so the n = 1 dummy rows of a padded batch and the padding
//      of short rows (a put's row holds about 4000 real bytes of 131,072)
//      cost their stores alone.
// Nothing here allocates or waits: the wrapper passes the (rows * lanes, 4)
// int32 scratch of the carries and the outputs, so a call can sit inside a
// captured CUDA graph.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 1024;
constexpr int kGroup = 255;
constexpr int kLanesPerBlock = 4;
constexpr int kRowThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The row's true length, clamped to [0, nmax].
__device__ __forceinline__ int row_len(const int64_t* n, int row, int nmax) {
  const int64_t v = n[row];
  return static_cast<int>(v < 0 ? 0 : (v > nmax ? nmax : v));
}

// Bytes emitted by one byte at group offset w.
__device__ __forceinline__ int emits(int w) { return (w < 3) + 2 * (w == 3); }

// Bytes emitted by the first d bytes of a run.
__device__ __forceinline__ int emitted_before(int d) {
  const int w = d % kGroup;
  return 5 * (d / kGroup) + (w <= 3 ? w : 5);
}

// One round of 32 bytes of a lane: the byte at p, whether it starts a run,
// and its run's start.  `prev` is the byte before the round (any value at
// p0 == 0), `carry` the run start before it (-1: none in the lane yet).
struct Round {
  uint32_t x;
  uint32_t bounds;  // ballot of the round's run starts
  int start;
};

__device__ __forceinline__ Round scan_round(const uint8_t* in, int p0, int end, int tid,
                                            uint32_t prev, int carry) {
  Round r;
  const int p = p0 + tid;
  const bool valid = p < end;
  r.x = valid ? in[p] : 0u;
  uint32_t before = __shfl_up_sync(kFull, r.x, 1);
  if (tid == 0) before = prev;
  r.bounds = __ballot_sync(kFull, valid && (p == 0 || r.x != before));
  const uint32_t upto = r.bounds & (kFull >> (31 - tid));
  r.start = upto ? p0 + 31 - __clz(upto) : carry;
  return r;
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
lane_counts_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ n,
                   int4* __restrict__ lanes_out, int nmax, int lanes, int rows) {
  const int tid = threadIdx.x & 31;
  const int lane = blockIdx.x * kLanesPerBlock + (threadIdx.x >> 5);
  if (lane >= rows * lanes) return;  // whole warps leave; no block barrier below
  const int row = lane / lanes;
  const int start = (lane - row * lanes) * kLane;
  const int end = min(start + kLane, row_len(n, row, nmax));
  if (end <= start) {
    if (tid == 0) lanes_out[lane] = make_int4(-1, start, 0, 0);
    return;
  }
  const uint8_t* in = data + static_cast<size_t>(row) * nmax;
  uint32_t prev = start > 0 ? in[start - 1] : 0u;
  int carry = -1, first = end, last = -1, count = 0;
  for (int p0 = start; p0 < end; p0 += 32) {
    const Round r = scan_round(in, p0, end, tid, prev, carry);
    // positions before the lane's first boundary continue a run that
    // started in an earlier lane: pass 2 counts them
    if (p0 + tid < end && r.start >= 0) count += emits((p0 + tid - r.start) % kGroup);
    if (r.bounds) {
      if (first == end) first = p0 + __ffs(r.bounds) - 1;
      last = p0 + 31 - __clz(r.bounds);
    }
    prev = __shfl_sync(kFull, r.x, 31);
    carry = __shfl_sync(kFull, r.start, 31);
  }
  count = __reduce_add_sync(kFull, count);
  if (tid == 0) lanes_out[lane] = make_int4(last, first, count, 0);
}

// Exclusive scan over the block's threads of one int each, by max or by sum;
// `total` gets the scan of all of them.
template <bool kMax>
__device__ int block_exclusive(int v, int identity, int* total) {
  __shared__ int warp_s[kRowThreads / 32];
  const int tid = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (tid >= d) incl = kMax ? max(incl, o) : incl + o;
  }
  if (tid == 31) warp_s[warp] = incl;
  __syncthreads();
  int base = identity, all = identity;
  for (int k = 0; k < kRowThreads / 32; ++k) {
    if (k < warp) base = kMax ? max(base, warp_s[k]) : base + warp_s[k];
    all = kMax ? max(all, warp_s[k]) : all + warp_s[k];
  }
  __syncthreads();
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (tid == 0) excl = identity;
  *total = all;
  return kMax ? max(base, excl) : base + excl;
}

__global__ void __launch_bounds__(kRowThreads)
row_offsets_kernel(int4* __restrict__ lanes_io, const int64_t* __restrict__ n,
                   int64_t* __restrict__ n_out, int nmax, int lanes) {
  const int row = blockIdx.x;
  const int len = row_len(n, row, nmax);
  const int active = (len + kLane - 1) / kLane;
  const int per = (active + kRowThreads - 1) / kRowThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, active);
  const int hi = min(lo + per, active);
  int4* rec = lanes_io + static_cast<size_t>(row) * lanes;
  // the run start carried into this thread's lanes
  int last = -1;
  for (int l = lo; l < hi; ++l) last = max(last, rec[l].x);
  int unused;
  int carry = block_exclusive<true>(last, -1, &unused);
  // each lane's count, its head's bytes included; the carry it starts with
  int sum = 0;
  for (int l = lo; l < hi; ++l) {
    int4 r = rec[l];
    const int a = l * kLane;
    int count = r.z;
    if (r.y > a) count += emitted_before(r.y - carry) - emitted_before(a - carry);
    rec[l] = make_int4(carry, 0, count, 0);
    carry = max(carry, r.x);
    sum += count;
  }
  int m;
  int off = block_exclusive<false>(sum, 0, &m);
  for (int l = lo; l < hi; ++l) {
    rec[l].y = off;
    off += rec[l].z;
  }
  if (threadIdx.x == 0) n_out[row] = m < len ? m : n[row];
}

// out[a, b) = in[a, b) with zeros from `len` on, or zeros alone (in null),
// by a warp.  With `vec` (rows that start on 16 bytes) 16 bytes a thread
// where the range is aligned to them, and bytes at its ragged ends.
__device__ void fill_range(uint8_t* out, const uint8_t* in, int a, int b, int len, bool vec,
                           int tid) {
  auto byte = [&](int p) { out[p] = in != nullptr && p < len ? in[p] : 0; };
  const int a16 = vec ? min((a + 15) & ~15, b) : b, b16 = vec ? max(b & ~15, a16) : b;
  for (int p = a + tid; p < a16; p += 32) byte(p);
  for (int p = b16 + tid; p < b; p += 32) byte(p);
  for (int q = a16 / 16 + tid; q < b16 / 16; q += 32) {
    const int p = q * 16;
    if (in != nullptr && p < len && p + 16 > len) {
      for (int k = p; k < p + 16; ++k) byte(k);
      continue;
    }
    reinterpret_cast<uint4*>(out)[q] = in != nullptr && p < len
        ? reinterpret_cast<const uint4*>(in)[q] : make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
lane_emit_kernel(const uint8_t* __restrict__ data, const int64_t* __restrict__ n,
                 const int4* __restrict__ lanes_in, const int64_t* __restrict__ n_out,
                 uint8_t* __restrict__ rows_out, int nmax, int lanes, int rows,
                 bool aligned) {
  const int tid = threadIdx.x & 31;
  const int lane = blockIdx.x * kLanesPerBlock + (threadIdx.x >> 5);
  if (lane >= rows * lanes) return;  // whole warps leave; no block barrier below
  const int row = lane / lanes;
  const int idx = lane - row * lanes;
  const int start = idx * kLane;
  const int lane_end = min(start + kLane, nmax);
  const int len = row_len(n, row, nmax);
  const uint8_t* in = data + static_cast<size_t>(row) * nmax;
  uint8_t* out = rows_out + static_cast<size_t>(row) * nmax;
  const int64_t m64 = n_out[row];
  if (len == 0 || m64 >= len) {  // the row stays itself
    fill_range(out, in, start, lane_end, len, aligned, tid);
    return;
  }
  const int m = static_cast<int>(m64);
  // this lane's share of the zeros past the encoding
  const int z0 = min(m + idx * kLane, nmax);
  fill_range(out, nullptr, z0, min(z0 + kLane, nmax), 0, aligned, tid);
  const int end = min(lane_end, len);
  if (end <= start) return;
  const int4 rec = lanes_in[lane];
  int carry = rec.x, off = rec.y;
  uint32_t prev = start > 0 ? in[start - 1] : 0u;
  for (int p0 = start; p0 < end; p0 += 32) {
    const Round r = scan_round(in, p0, end, tid, prev, carry);
    const int p = p0 + tid;
    const bool valid = p < end;
    const int w = (p - r.start) % kGroup;
    const int e = valid ? emits(w) : 0;
    int incl = e;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (tid >= d) incl += o;
    }
    const int o = off + incl - e;
    uint32_t next = __shfl_down_sync(kFull, r.x, 1);
    if ((tid == 31 || p + 1 >= end) && p + 1 < len) next = in[p + 1];
    if (valid) {
      const uint8_t v = static_cast<uint8_t>(r.x);
      if (e) out[o] = v;
      if (w >= 3 && (p + 1 >= len || next != r.x || w == kGroup - 1))
        out[w == 3 ? o + 1 : o - 1] = static_cast<uint8_t>(w - 3);
    }
    off += __shfl_sync(kFull, incl, 31);
    prev = __shfl_sync(kFull, r.x, 31);
    carry = __shfl_sync(kFull, r.start, 31);
  }
}

}  // namespace

extern "C" int bmh_rle1_encode_rows(const void* data, const void* n, void* scratch,
                                    void* rows_out, void* n_out, int rows, int nmax,
                                    int lanes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows * lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  if (blocks > 0) {
    const uint8_t* d = static_cast<const uint8_t*>(data);
    const int64_t* nn = static_cast<const int64_t*>(n);
    int4* rec = static_cast<int4*>(scratch);
    int64_t* no = static_cast<int64_t*>(n_out);
    lane_counts_kernel<<<blocks, 32 * kLanesPerBlock, 0, s>>>(d, nn, rec, nmax, lanes, rows);
    row_offsets_kernel<<<rows, kRowThreads, 0, s>>>(rec, nn, no, nmax, lanes);
    // 16-byte accesses need rows that start on 16 bytes
    const bool aligned = nmax % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(rows_out) % 16 == 0;
    lane_emit_kernel<<<blocks, 32 * kLanesPerBlock, 0, s>>>(
        d, nn, rec, no, static_cast<uint8_t*>(rows_out), nmax, lanes, rows, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}
