// Kernel K5: bitonic sort of int32 (k1, k2, idx) triples, row by row.
//
// Replaces bmh_tpu/ops/pallas_sort.py sort3 / _sort_kernel, the Pallas
// bitonic network that holds a whole row in VMEM and exchanges partners by
// rolling the (S, 128) tile.  Each row of the (B, N) inputs (N a power of
// two in [1024, 2^18]) comes out ascending by the triple; with distinct
// triples that is the stable sort by (k1, k2).
//
// What bounds it: a comparison sort's least work is one read and one write
// of the 12-byte triples (bytes); the network does log2(N) (log2(N) + 1) / 2
// compare-exchange steps, so the kernel is bound by how many of those steps
// one pass through device memory can carry, and by what a step costs
// between passes.
//
// What the design does about it.  A thread holds 8 triples in registers and
// a block a tile of T = 2^t triples (8 * threads; t = 12, or the whole row
// below that; the high passes' tile is 2^13).  Which three
// bits of a triple's tile index select the register, which five the lane
// and which the warp is a layout; a compare-exchange at distance 2^q costs
// no memory when q is a register bit and three warp shuffles when it is a
// lane bit.  Two layouts cover every distance inside a tile:
//   L  registers = bits 0, 1 and 7, lanes = bits 2..6, warps = bits
//      8..t-1: distances 2^7..2^0; a thread's triples are two runs of 4
//      neighbours, so it moves each plane to and from device memory as
//      two 16-byte words and a warp 512 contiguous bytes at a time;
//   H  registers = bits t-3..t-1, lanes = bits 8..t-4 and the lowest
//      bits, warps = the rest: distances 2^(t-1)..2^8.
// Moving a tile between them is one trip through shared memory (12 B per
// triple, three int32 planes, addresses swizzled so that neither layout has
// a bank conflict).  Nothing else touches shared memory.  Triples compare
// as signed int32 words in order, so the keys' extremes (-2^31, the biased
// init ranks; 2^31 - 1, the pads) need no bias.  Three kinds of launch, each one read and one write of every triple:
//   sort   all stages k <= t of a tile: stages 1..8 in L without any
//          memory (20 of their 36 steps shuffle), then per stage H
//          (distances >= 2^8), L (the rest);
//   high   for a stage k > t, the distances 2^(k-1)..2^t: a block gathers
//          32 runs of 256 triples that lie 2^g0 apart straight into layout
//          H of a 2^13 tile, so up to 5 distances cost one pass and no
//          shared memory at all;
//   merge  the stage's distances below 2^t: load into H, one trip to L,
//          store.
// The high passes take a 2^13 tile (most distances a pass, no shared
// memory).  For the sort and merge tile, measured on the H100, 2^12 with
// two 512-thread blocks to an SM beat 2^13 with one block of 1024, whose
// loads, steps and stores do not overlap; its 48 KB of shared memory also
// need no opt-in.  A (32, 131072) sort at t = 12 is 1 + 5 * 2 = 11 passes where one
// launch per distance made 21.  Merge-path passes above the tile, or
// persistent blocks that prefetch the next tile, are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kE = 8;         // triples a thread holds
constexpr int kHighLog = 13;  // log2 of the high passes' tile
enum Kind { kSort = 1, kHigh = 2, kMerge = 4 };  // bits of `kinds`

struct Regs {
  int32_t a[kE], b[kE], c[kE];
};

template <int LOG_T>
struct Lay {
  static constexpr int T = 1 << LOG_T;
  static constexpr int HI = LOG_T > 11 ? LOG_T - 11 : 0;  // H's shuffled bits 8..
  static constexpr int LO = 5 - HI;                       // H's low lane bits
  static constexpr int TOP = LOG_T - 3;                   // H's register bits
  __device__ static __forceinline__ int xl(int lane, int warp, int e) {
    return (e & 3) | (lane << 2) | ((e >> 2) << 7) | (warp << 8);
  }
  __device__ static __forceinline__ int xh(int lane, int warp, int e) {
    return (lane & ((1 << LO) - 1)) | (warp << LO) | ((lane >> LO) << 8) | (e << TOP);
  }
  // shared-memory slot of tile index x, free of bank conflicts in both
  // layouts: L's lane bits 5, 6 fold into bank bits 0, 1, H's lane bits
  // 8.. into the bank bits that its low lane bits leave constant
  __device__ static __forceinline__ int swz(int x) {
    return x ^ ((x >> 5) & 3) ^ (((x >> 8) << LO) & 31);
  }
};

__device__ __forceinline__ bool gt3(int32_t a1, int32_t a2, int32_t a3,
                                    int32_t b1, int32_t b2, int32_t b3) {
  return a1 > b1 || (a1 == b1 && (a2 > b2 || (a2 == b2 && a3 > b3)));
}

// Compare-exchange across register bit BIT.  Bit e of `asc` says whether
// the triple in register e sorts ascending in this stage.
template <int BIT>
__device__ __forceinline__ void cx_regs(Regs& r, unsigned asc) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    if ((e >> BIT) & 1) continue;
    const int f = e | (1 << BIT);
    const bool up = (asc >> e) & 1;
    const bool s = gt3(r.a[e], r.b[e], r.c[e], r.a[f], r.b[f], r.c[f]) == up;
    const int32_t ta = r.a[e], tb = r.b[e], tc = r.c[e];
    r.a[e] = s ? r.a[f] : ta;
    r.b[e] = s ? r.b[f] : tb;
    r.c[e] = s ? r.c[f] : tc;
    r.a[f] = s ? ta : r.a[f];
    r.b[f] = s ? tb : r.b[f];
    r.c[f] = s ? tc : r.c[f];
  }
}

// Compare-exchange with the lane `mask` away; `upper` is this lane's bit.
__device__ __forceinline__ void cx_lane(Regs& r, int mask, unsigned asc, bool upper) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int32_t pa = __shfl_xor_sync(0xffffffffu, r.a[e], mask);
    const int32_t pb = __shfl_xor_sync(0xffffffffu, r.b[e], mask);
    const int32_t pc = __shfl_xor_sync(0xffffffffu, r.c[e], mask);
    const bool up = (asc >> e) & 1;
    // the lower lane of an ascending pair keeps the smaller triple
    const bool take = gt3(r.a[e], r.b[e], r.c[e], pa, pb, pc) == (up != upper);
    r.a[e] = take ? pa : r.a[e];
    r.b[e] = take ? pb : r.b[e];
    r.c[e] = take ? pc : r.c[e];
  }
}

// Layout L: the steps at distances 2^Q..2^0 that are <= 2^qhi.
template <int Q>
__device__ __forceinline__ void steps_l(Regs& r, unsigned asc, int lane, int qhi) {
  if (Q <= qhi) {
    if constexpr (Q == 7) cx_regs<2>(r, asc);
    else if constexpr (Q < 2) cx_regs<Q>(r, asc);
    else cx_lane(r, 1 << (Q - 2), asc, (lane >> (Q - 2)) & 1);
  }
  if constexpr (Q > 0) steps_l<Q - 1>(r, asc, lane, qhi);
}

// Layout H: the steps at distances 2^Q..2^8 that lie in [2^qlo, 2^qhi].
template <int LOG_T, int Q>
__device__ __forceinline__ void steps_h(Regs& r, unsigned asc, int lane, int qlo,
                                        int qhi) {
  using L = Lay<LOG_T>;
  if (Q >= qlo && Q <= qhi) {
    if constexpr (Q >= L::TOP) cx_regs<Q - L::TOP>(r, asc);
    else cx_lane(r, 1 << (L::LO + Q - 8), asc, (lane >> (L::LO + Q - 8)) & 1);
  }
  if constexpr (Q > 8) steps_h<LOG_T, Q - 1>(r, asc, lane, qlo, qhi);
}

// Which registers sort ascending in stage k: bit k of the row position.
template <int LOG_T, bool H>
__device__ __forceinline__ unsigned asc_mask(int pos0, int lane, int warp, int k) {
  using L = Lay<LOG_T>;
  unsigned m = 0;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int x = pos0 | (H ? L::xh(lane, warp, e) : L::xl(lane, warp, e));
    m |= (((x >> k) & 1) ^ 1) << e;
  }
  return m;
}

// One trip through shared memory: out of layout H into L, or back.
template <int LOG_T, bool FROM_H>
__device__ __forceinline__ void relayout(Regs& r, int32_t* smem, int lane, int warp) {
  using L = Lay<LOG_T>;
  int32_t* s1 = smem;
  int32_t* s2 = smem + L::T;
  int32_t* s3 = smem + 2 * L::T;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int s = L::swz(FROM_H ? L::xh(lane, warp, e) : L::xl(lane, warp, e));
    s1[s] = r.a[e];
    s2[s] = r.b[e];
    s3[s] = r.c[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int s = L::swz(FROM_H ? L::xl(lane, warp, e) : L::xh(lane, warp, e));
    r.a[e] = s1[s];
    r.b[e] = s2[s];
    r.c[e] = s3[s];
  }
}

// A thread's 8 values of one plane in layout L, as two 16-byte words that
// lie 128 triples apart; a warp moves 512 contiguous bytes per word.
__device__ __forceinline__ void load8(const int32_t* p, int32_t (&v)[kE]) {
  const int4 lo = reinterpret_cast<const int4*>(p)[0];
  const int4 hi = reinterpret_cast<const int4*>(p + 128)[0];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void store8(int32_t* p, const int32_t (&v)[kE]) {
  reinterpret_cast<int4*>(p)[0] = make_int4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<int4*>(p + 128)[0] = make_int4(v[4], v[5], v[6], v[7]);
}

// The tile sort (MERGE false: every stage k <= LOG_T, `in*` to `out*`) or
// the merge pass of stage k > LOG_T (MERGE true: the distances below
// 2^LOG_T, in place on `out*`).  Block m owns tile m.
template <int LOG_T, bool MERGE>
__global__ void __launch_bounds__(1 << (LOG_T - 3), 1024 >> (LOG_T - 3))
sort3_tile(const int32_t* in1, const int32_t* in2, const int32_t* in3,
           int32_t* out1, int32_t* out2, int32_t* out3, int log_n, int k) {
  using L = Lay<LOG_T>;
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) << LOG_T;
  const int pos0 = static_cast<int>(base & ((1LL << log_n) - 1));
  const long long g = base + L::xl(lane, warp, 0);
  Regs r;
  if constexpr (MERGE) {
    const unsigned asc = ((pos0 >> k) & 1) ? 0u : 0xFFu;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const long long gh = base + L::xh(lane, warp, e);
      r.a[e] = out1[gh];
      r.b[e] = out2[gh];
      r.c[e] = out3[gh];
    }
    steps_h<LOG_T, LOG_T - 1>(r, asc, lane, 8, LOG_T - 1);
    relayout<LOG_T, true>(r, smem, lane, warp);
    steps_l<7>(r, asc, lane, 7);
  } else {
    load8(in1 + g, r.a);
    load8(in2 + g, r.b);
    load8(in3 + g, r.c);
#pragma unroll 1
    for (int kk = 1; kk <= 8; ++kk)
      steps_l<7>(r, asc_mask<LOG_T, false>(pos0, lane, warp, kk), lane, kk - 1);
#pragma unroll 1
    for (int kk = 9; kk <= LOG_T; ++kk) {
      relayout<LOG_T, false>(r, smem, lane, warp);
      steps_h<LOG_T, LOG_T - 1>(r, asc_mask<LOG_T, true>(pos0, lane, warp, kk),
                                lane, 8, kk - 1);
      relayout<LOG_T, true>(r, smem, lane, warp);
      steps_l<7>(r, asc_mask<LOG_T, false>(pos0, lane, warp, kk), lane, 7);
    }
  }
  store8(out1 + g, r.a);
  store8(out2 + g, r.b);
  store8(out3 + g, r.c);
}

// A high pass of stage k, in place: block m gathers the 32 runs of 256
// triples whose row bits g0..g0+4 count 0..31 (its other bits come from m)
// into layout H of a 2^13 tile and runs the steps on tile bits qhi..qlo,
// which are row bits g0 + q - 8.  No shared memory.
__global__ void __launch_bounds__(1 << (kHighLog - 3), 1)
sort3_high(int32_t* p1, int32_t* p2, int32_t* p3, int log_n, int k, int g0,
           int qlo, int qhi) {
  using L = Lay<kHighLog>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row_mask = (1LL << log_n) - 1;
  const long long m = blockIdx.x;
  const int low = g0 - 8;
  const long long base = ((m & ((1LL << low) - 1)) << 8) |
                         ((m >> low) << (g0 + kHighLog - 8));
  // bit k of the row position: one of the window's bits, or the block's
  const unsigned asc = k >= g0 && k < g0 + kHighLog - 8
                           ? asc_mask<kHighLog, true>(0, lane, warp, 8 + k - g0)
                           : ((((base & row_mask) >> k) & 1) ? 0u : 0xFFu);
  Regs r;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int x = L::xh(lane, warp, e);
    const long long g = base + (x & 255) + (static_cast<long long>(x >> 8) << g0);
    r.a[e] = p1[g];
    r.b[e] = p2[g];
    r.c[e] = p3[g];
  }
  steps_h<kHighLog, kHighLog - 1>(r, asc, lane, qlo, qhi);
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int x = L::xh(lane, warp, e);
    const long long g = base + (x & 255) + (static_cast<long long>(x >> 8) << g0);
    p1[g] = r.a[e];
    p2[g] = r.b[e];
    p3[g] = r.c[e];
  }
}

template <int LOG_T>
cudaError_t run(const int32_t* k1, const int32_t* k2, const int32_t* id,
                int32_t* o1, int32_t* o2, int32_t* o3, int b, int log_n,
                int kinds, cudaStream_t s) {
  constexpr int kTile = 1 << LOG_T;
  constexpr int kThreads = kTile / kE;
  constexpr size_t kSmem = 3 * sizeof(int32_t) * kTile;
  static_assert(kSmem <= 48 * 1024, "a larger tile needs the shared-memory opt-in");
  const long long total = static_cast<long long>(b) << log_n;
  const int tiles = static_cast<int>(total >> LOG_T);
  if (tiles == 0) return cudaSuccess;
  cudaError_t err;
  if (kinds & kSort) {
    sort3_tile<LOG_T, false><<<tiles, kThreads, kSmem, s>>>(
        k1, k2, id, o1, o2, o3, log_n, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  for (int k = LOG_T + 1; k <= log_n; ++k) {
    int j_hi = k - 1;  // the longest distance of the stage still to do
    while (j_hi >= LOG_T) {
      // the window of 5 row bits that ends at j_hi, not below bit 8
      const int g0 = j_hi - 4 > 8 ? j_hi - 4 : 8;
      const int j_lo = g0 > LOG_T ? g0 : LOG_T;
      if (kinds & kHigh) {
        sort3_high<<<static_cast<int>(total >> kHighLog), 1 << (kHighLog - 3), 0, s>>>(
            o1, o2, o3, log_n, k, g0, 8 + j_lo - g0, 8 + j_hi - g0);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
      }
      j_hi = j_lo - 1;
    }
    if (kinds & kMerge) {
      sort3_tile<LOG_T, true><<<tiles, kThreads, kSmem, s>>>(
          o1, o2, o3, o1, o2, o3, log_n, k);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// Sorts each of the b rows of 2^log_n triples from (k1, k2, id) into
// (o1, o2, o3), all 16-byte aligned, with tiles of 2^log_t triples (10..12,
// at most log_n; a tile below the row needs rows of at least 2^13 for the
// high passes).  kinds: which launches to make, a sum of 1 (the tile sort),
// 2 (the high passes) and 4 (the merge passes); 7 is the sort, the single
// bits are for timing a kind on its own.  Returns the first
// cudaGetLastError() that is not 0, or cudaErrorInvalidValue for arguments
// it does not take.
extern "C" int bmh_sort3(const void* k1, const void* k2, const void* id,
                         void* o1, void* o2, void* o3, int b, int log_n,
                         int log_t, int kinds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a1 = static_cast<const int32_t*>(k1);
  const auto* a2 = static_cast<const int32_t*>(k2);
  const auto* a3 = static_cast<const int32_t*>(id);
  auto* p1 = static_cast<int32_t*>(o1);
  auto* p2 = static_cast<int32_t*>(o2);
  auto* p3 = static_cast<int32_t*>(o3);
  if (log_t > log_n || log_n > 30 || (log_t < log_n && log_n < kHighLog))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (log_t) {
    case 10: return static_cast<int>(run<10>(a1, a2, a3, p1, p2, p3, b, log_n, kinds, s));
    case 11: return static_cast<int>(run<11>(a1, a2, a3, p1, p2, p3, b, log_n, kinds, s));
    case 12: return static_cast<int>(run<12>(a1, a2, a3, p1, p2, p3, b, log_n, kinds, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
