// Kernel K4: the checkpointed inverse-BWT LF walk.
//
// Replaces bmh_tpu/ops/pallas_ibwt.py ibwt_walk / _ibwt_kernel (which
// Mosaic refused, so bmh_tpu runs the walk as the XLA scan in
// ops/bwt.py bwt_inverse_cursors, over the self-composed LF² table for
// blocks <= 64 KiB).  Each of the k cursors of a block follows the packed
// table entry = (byte << 23) | next_row for `steps` LF steps and emits one
// byte per step.
//
// What bounds it: the latency of dependent loads, not bytes.  Step s+1's
// address is step s's loaded value, so a cursor has one load in flight; the
// only parallelism is across cursors (B*k = 1024 for a 32-block batch of
// 128 KiB blocks, fixed by the container's checkpoint stride).  One step
// costs one L2 hit however little it moves.
//
// What the design does about it: independent loads are cheap on this card,
// dependent ones are not, so the table is composed with itself before the
// walk and the dependent chain gets 16 times shorter.  Two modes:
//   hop 1   the source table itself, one byte a step (the knob lf2 off);
//   hop 16  rows only.  `compose_rows` runs one thread per row, all loads
//           independent: four doubling passes (one gather a row each) turn
//           the table's row links into links 16 steps long, a uint32 table
//           as large as the source (16 MiB for a 32-block batch, so it
//           stays in the L2).  `walk_rows` is the dependent chain: steps /
//           16 loads a cursor, recording the row it stands on before each.
//           `fill_bytes`, one thread per recorded row, then follows the
//           source table 16 steps from there and stores the bytes 8 at a
//           time; its loads depend on each other only within a thread, so
//           it runs at the memory system's throughput, not its latency.
// An entry that also holds the bytes of its steps (bmh_tpu's 32-bit LF²
// entry for hop 2, a 64-bit entry for hop 2 or 4) was measured on the H100
// and lost at every block size: the chain stays 1024 to 2048 loads long,
// and a 64-bit table of a 32-block batch (32 MiB) misses the L2 right after
// it is written.  Hops 8, 32 and 64 of the rows-only form were measured
// too: 8 is slower, 32 within the run-to-run spread of 16 with one more
// pass and no shorter whole call, 64 slower again (each doubling pass costs
// as much as it saves from there on).
// Pad rows carry the byte field 256 and link to themselves: the byte is
// masked to 8 bits, so a start clamped onto a pad emits zeros in both
// modes.  Cursors spread over many SMs, one to a block up to 1024 cursors:
// a warp waits at every step for the slowest of its lanes' loads, so a
// cursor alone in its block walks fastest.  Tables are read through the
// read-only path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLfMask = (1u << 23) - 1;
constexpr int kComposeThreads = 256;
constexpr int kHop = 16;           // LF steps one composed link covers
constexpr int kWalkBlocks = 1024;  // walk blocks wanted: a cursor to a block up to here

// dst[i] = src[src[i]]: the row links composed with themselves, read from
// src's low 23 bits (src is the source table or an earlier composition).
__global__ void compose_rows(const uint32_t* __restrict__ src,
                             uint32_t* __restrict__ dst, int nmax, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const uint32_t* t = src + (i / nmax) * nmax;
  dst[i] = __ldg(t + (src[i] & kLfMask)) & kLfMask;
}

// The dependent chain over row links alone: records where each cursor
// stands before each of its `hops` jumps.
__global__ void walk_rows(const uint32_t* __restrict__ links,
                          const int32_t* __restrict__ starts,
                          uint32_t* __restrict__ visited, int nmax, int k, int hops,
                          int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const uint32_t* t = links + static_cast<size_t>(i / k) * nmax;
  uint32_t* v = visited + static_cast<size_t>(i) * hops;
  uint32_t r = static_cast<uint32_t>(starts[i]);
  for (int s = 0; s < hops; ++s) {
    v[s] = r;
    r = __ldg(t + r);
  }
}

// One thread per recorded row: the kHop bytes that the walk emits from
// there, read off the source table.
__global__ void fill_bytes(const uint32_t* __restrict__ table,
                           const uint32_t* __restrict__ visited,
                           uint8_t* __restrict__ out, int nmax, int per_block,
                           long long total) {
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= total) return;
  const uint32_t* t = table + (v / per_block) * nmax;
  unsigned long long* o = reinterpret_cast<unsigned long long*>(out + v * kHop);
  uint32_t r = visited[v];
  for (int w = 0; w < kHop / 8; ++w) {
    unsigned long long word = 0;
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const uint32_t g = __ldg(t + r);
      word |= static_cast<unsigned long long>((g >> 23) & 0xFFu) << (8 * h);
      r = g & kLfMask;
    }
    o[w] = word;
  }
}

__global__ void walk_hop1(const uint32_t* __restrict__ table,
                          const int32_t* __restrict__ starts,
                          uint8_t* __restrict__ out, int nmax, int k, int steps,
                          int total) {
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

// Walks b * k cursors `steps` steps over `table` ((b, nmax) uint32) into
// `out` ((b, k, steps) bytes).  hop 1 reads `table` itself and needs no
// scratch; hop 16 (steps a multiple of 16) first composes the row links
// into `scratch`, 2 * b * nmax + b * k * steps / 16 32-bit words.  parts:
// bit 0 runs the compose passes, bit 1 the walk and the fill; 3 is the
// whole call, the single bits are for timing the parts.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int bmh_ibwt_walk(const void* table, const void* starts, void* out,
                             void* scratch, int b, int nmax, int k, int steps,
                             int hop, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* o = static_cast<uint8_t*>(out);
  const int total = b * k;
  const long long rows = static_cast<long long>(b) * nmax;
  if ((hop != 1 && hop != kHop) || steps % hop != 0 || nmax > (1 << 23) ||
      (hop > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0 || rows == 0) return 0;
  // a cursor to a block until there are more cursors than blocks worth having
  const int share = total / kWalkBlocks;
  const int lanes = share < 1 ? 1 : (share > 32 ? 32 : share);
  const int wblocks = (total + lanes - 1) / lanes;
  if (hop == 1) {
    if (parts & 2)
      walk_hop1<<<wblocks, lanes, 0, s>>>(tab, st, o, nmax, k, steps, total);
    return static_cast<int>(cudaGetLastError());
  }
  // links = the table's row links composed 16 times: four doublings that
  // alternate between the two buffers and end in the second
  auto* buf_a = static_cast<uint32_t*>(scratch);
  auto* buf_b = buf_a + rows;
  auto* visited = buf_b + rows;
  const int cblocks = static_cast<int>((rows + kComposeThreads - 1) / kComposeThreads);
  cudaError_t err;
  if (parts & 1) {
    const uint32_t* src = tab;
    for (int h = 1; h < kHop; h *= 2) {
      uint32_t* dst = src == buf_a ? buf_b : buf_a;
      compose_rows<<<cblocks, kComposeThreads, 0, s>>>(src, dst, nmax, rows);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      src = dst;
    }
  }
  if (parts & 2) {
    const int hops = steps / kHop;
    const long long recorded = static_cast<long long>(total) * hops;
    walk_rows<<<wblocks, lanes, 0, s>>>(buf_b, st, visited, nmax, k, hops, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (recorded > 0)
      fill_bytes<<<static_cast<int>((recorded + kComposeThreads - 1) / kComposeThreads),
                   kComposeThreads, 0, s>>>(tab, visited, o, nmax, k * hops, recorded);
  }
  return static_cast<int>(cudaGetLastError());
}
