// Kernels K1 and K2: the canonical-Huffman gap decode.
//
// Replace bmh_tpu/ops/pallas_decode.py phase_a / _phase_a_kernel (K1) and
// phase_b / _phase_b_kernel (K2).  The payload of a batch is cut into
// chunks of chunk_bits bits.  Both kernels run the canonical FSM
//     r' = 2 (r - c) + bit,   complete  <=>  0 <= r' < count[len + 1]
// (c = count[len], emitted canonical index = o + r' with o the running
// offset) over chunk_bits + 32 bits of each chunk.  The state returns to
// (0, 0, 0) after every completed codeword and after every overflow
// (len + 1 > maxl): such a bit position is a boundary.
//   K1: for each chunk and each of the 32 entry gaps g, the codewords a
//       decode entering at bit g completes and its exit gap (where its last
//       codeword ends past the chunk end; 0 if none does).
//   K2: one thread per chunk; from the chunk's true entry gap it re-decodes
//       and writes the canonical index of every completed codeword (or -1)
//       per step, time-major (steps, NC).
//
// What bounds them: a dependent chain.  A step is a handful of integer
// operations and a table lookup, each waiting for the step before it; the
// bytes (4 (wpc + 1) of words and 128 of counts in, 256 out per chunk for
// K1; K2's (steps, NC) int32 output) and the operations are small beside
// the chain's latency times its length.
//
// What K1's design does about it, one thread per chunk:
//   * It walks every distinct decode once.  From a boundary at bit p the
//     rest of a decode depends on p alone, so two gaps whose decodes reach
//     one boundary are one decode from there, and on real payloads a
//     chunk's 32 decodes merge within a few codewords.  The thread takes
//     the gaps from 31 down to 0.  Where a gap's decode lands it looks the
//     position up in a per-chunk memo in shared memory: a bitmap of visited
//     positions and, per position, the gap that first came by and the
//     codewords it had completed until there.  On a visited position the
//     gap is finished: its count is its own so far plus what that earlier
//     gap completed from there on, its exit gap is that gap's.  Every turn
//     of the loop therefore decodes at a position nobody has visited, and a
//     chunk costs at most chunk_bits + 32 turns whatever the table: nothing
//     is left of the 32-fold walk, not even under a table that lets no two
//     decodes meet.
//   * A turn is a codeword, not a bit.  The FSM completes at the first
//     length l with count[l] > 0 and prefix_l < sum_{k<=l} count[k] 2^(l-k)
//     (by induction r stays >= 0 for counts >= 0), that is with the 32-bit
//     window w at p below lim[l] = sum_{k<=l} count[k] 2^(32-k).  lim rises
//     with l, so the length is 1 + #{l <= maxl : w >= lim[l]}, and
//     maxl + 1 of them mean the overflow reset (a boundary that counts no
//     symbol).  The thread holds lim[1..31] in registers (halved, so that a
//     full code space fits 32 bits; saturated, so that an over-subscribed
//     table completes where the FSM does) and finds a length by 31
//     independent compares, not by up to 31 dependent FSM steps.  A
//     codeword that would end past chunk_bits + 32 ends the decode as the
//     FSM's running out of bits does.
//   * What a turn waits for is loaded together: the words under the next
//     position, its visited bit and its memo entry all depend on that
//     position alone.
// The chunk's words (wpc + 1 and two of zeros) lie in shared memory too,
// every array laid out [index][thread].
//
// What K2 does: bits are read straight from the packed words (one 32-bit
// load per 32 steps, held in a register) and the chunk's per-length count
// table is indexed directly from shared memory (laid out [length][thread],
// conflict-free).  The TPU's unrolled compare-select over lengths and its
// (32, TILE) plane of lanes in lock-step exist only because its vector unit
// can neither gather nor branch per lane.  Warps run over consecutive
// chunks, so the word loads of a step and K2's stores are contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGaps = 32;
constexpr int kMaxLen = 31;
constexpr int kAmax = 256;
constexpr int kThreads = 128;
// K1: shared memory a block may opt in to, and the most threads a block has
constexpr int kMaxShared = 232448;
constexpr int kChunkThreads = 32;

__device__ __forceinline__ void load_counts(int32_t (*cnt_s)[kThreads],
                                            const int32_t* count_t, int nc,
                                            int c) {
  for (int l = 0; l <= kMaxLen; ++l)
    cnt_s[l][threadIdx.x] = count_t[static_cast<size_t>(l) * nc + c];
}

// K1's shared memory for a block of `threads` chunks, every array laid out
// [index][thread]: totals[32] (per finished gap, count << 5 | exit gap),
// words[wpc + 3], seen[] (bitmap over bit positions 0 .. chunk_bits + 32),
// memo[positions] of Memo (gap << kShift | codewords completed until there).
template <typename Memo>
__host__ __device__ constexpr size_t phase_a_shared(int chunk_bits, int threads) {
  const size_t positions = chunk_bits + kGaps + 1;
  const size_t words = chunk_bits / 32 + 3;
  return threads * (4 * (kGaps + words + (positions + 31) / 32) + sizeof(Memo) * positions);
}

template <typename Memo>
__global__ void phase_a_kernel(const uint32_t* __restrict__ wext,
                               const int32_t* __restrict__ count_t,
                               int32_t* __restrict__ cnt_out,
                               int32_t* __restrict__ exit_out,
                               int nc, int chunk_bits, int maxl) {
  constexpr int kShift = 8 * sizeof(Memo) - 5;
  extern __shared__ uint32_t shared[];
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int c = blockIdx.x * nthr + tid;
  if (c >= nc) return;  // no block-wide barrier below
  const int steps = chunk_bits + kGaps;
  const int seen_words = (steps + 1 + 31) / 32;
  const int wrows = chunk_bits / 32 + 1;
  int32_t* tot_s = reinterpret_cast<int32_t*>(shared) + tid;
  uint32_t* word_s = reinterpret_cast<uint32_t*>(tot_s + kGaps * nthr);
  uint32_t* seen_s = word_s + (wrows + 2) * nthr;
  Memo* memo_s = reinterpret_cast<Memo*>(seen_s + seen_words * nthr - tid) + tid;
  // lim[l] = min(sum_{k<=l} count[k] 2^(31-k), 2^31) up to maxl; above it a
  // value that no halved window reaches
  uint32_t lim[kMaxLen + 1];
  unsigned long long acc = 0;
#pragma unroll
  for (int l = 1; l <= kMaxLen; ++l) {
    const int cnt = count_t[static_cast<size_t>(l) * nc + c];
    acc = min(acc + (static_cast<unsigned long long>(max(cnt, 0)) << (31 - l)), 1ull << 31);
    lim[l] = l <= maxl ? static_cast<uint32_t>(acc) : 0xffffffffu;
  }
  for (int w = 0; w < wrows; ++w)
    word_s[w * nthr] = wext[static_cast<size_t>(w) * nc + c];
  word_s[wrows * nthr] = 0;
  word_s[(wrows + 1) * nthr] = 0;
  for (int w = 0; w < seen_words; ++w) seen_s[w * nthr] = 0;

  // every turn decodes the codeword at t, a position below steps that is
  // marked and that no earlier turn has decoded at
  int g = kGaps - 1, t = g, done = 0;
  seen_s[0] = 1u << t;
  memo_s[t * nthr] = static_cast<Memo>(static_cast<uint32_t>(g) << kShift);
  uint32_t w0 = word_s[0], w1 = word_s[nthr];
  while (g >= 0) {
    const uint32_t window = __funnelshift_l(w1, w0, t & 31) >> 1;
    int part[4] = {1, 0, 0, 0};
#pragma unroll
    for (int l = 1; l <= kMaxLen; ++l) part[l & 3] += window >= lim[l];
    const int len = (part[0] + part[1]) + (part[2] + part[3]);
    t += len;
    // what the next turn needs, and what tells whether there is one
    const int at = min(t, steps);
    const uint32_t seen = seen_s[(at >> 5) * nthr];
    const uint32_t memo = memo_s[at * nthr];
    uint32_t next_w0 = word_s[(at >> 5) * nthr];
    uint32_t next_w1 = word_s[((at >> 5) + 1) * nthr];
    const uint32_t bit = 1u << (at & 31);
    bool finished = true;
    int total = done, ex = 0;
    if (t <= steps) {  // else the bits ran out inside the codeword: exit gap 0
      const bool complete = len <= maxl;
      if (complete) {
        total = ++done;
        if (t >= chunk_bits) ex = min(t - chunk_bits, kGaps - 1);
      }
      if (t < steps && !(complete && t >= chunk_bits)) {
        if (seen & bit) {  // an earlier gap came by here: the rest is its
          const int32_t tot = tot_s[(memo >> kShift) * nthr];
          total = done + (tot >> 5) - static_cast<int>(memo & ((1u << kShift) - 1));
          ex = tot & 31;
        } else {
          finished = false;
          seen_s[(t >> 5) * nthr] = seen | bit;
          memo_s[t * nthr] = static_cast<Memo>((static_cast<uint32_t>(g) << kShift) | done);
        }
      }
    }
    if (finished) {
      tot_s[g * nthr] = (total << 5) | ex;
      const size_t o = static_cast<size_t>(g) * nc + c;
      cnt_out[o] = total;
      exit_out[o] = ex;
      --g;
      // position g is new: only decodes entering at lower gaps can come by
      t = max(g, 0);
      done = 0;
      seen_s[0] |= 1u << t;
      memo_s[t * nthr] = static_cast<Memo>(static_cast<uint32_t>(t) << kShift);
      next_w0 = word_s[0];
      next_w1 = word_s[nthr];
    }
    w0 = next_w0;
    w1 = next_w1;
  }
}

__global__ void phase_b_kernel(const uint32_t* __restrict__ wext,
                               const int32_t* __restrict__ count_t,
                               const int32_t* __restrict__ entry,
                               int32_t* __restrict__ idx_out,
                               int nc, int chunk_bits, int maxl) {
  __shared__ int32_t cnt_s[kMaxLen + 1][kThreads];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= nc) return;
  load_counts(cnt_s, count_t, nc, c);
  const int e = entry[c];
  const int wrows = chunk_bits / 32 + 1;
  int r = 0, ln = 0, cc = 0, o = 0;
  bool done = false;
  for (int w = 0; w < wrows; ++w) {
    const uint32_t word = wext[static_cast<size_t>(w) * nc + c];
    for (int b = 0; b < 32; ++b) {
      const int t = w * 32 + b;
      const bool active = !done && t >= e;
      const int bit = (word >> (31 - b)) & 1;
      const int r_n = 2 * (r - cc) + bit;
      const int ln_n = ln + 1;
      const int c_n = ln_n <= maxl ? cnt_s[ln_n][threadIdx.x] : 0;
      const bool complete = c_n > 0 && r_n >= 0 && r_n < c_n;
      const bool fire = active && complete;
      int v = o + r_n;
      v = v < 0 ? 0 : (v > kAmax ? kAmax : v);
      idx_out[static_cast<size_t>(t) * nc + c] = fire ? v : -1;
      if (active) {
        if (complete || ln_n > maxl) {
          r = 0; ln = 0; cc = 0; o = 0;
        } else {
          r = r_n; ln = ln_n; cc = c_n; o += c_n;
        }
      }
      if (fire && t + 1 >= chunk_bits) done = true;
    }
  }
}

template <typename Memo>
int launch_phase_a(const uint32_t* wext, const int32_t* count_t, int32_t* cnt_out,
                   int32_t* exit_out, int nc, int chunk_bits, int maxl,
                   cudaStream_t stream) {
  // as many chunks a block as the memo leaves room for, at most a warp
  int threads = kChunkThreads;
  while (threads > 1 && phase_a_shared<Memo>(chunk_bits, threads) > kMaxShared) threads /= 2;
  const size_t shared = phase_a_shared<Memo>(chunk_bits, threads);
  if (shared > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  // once per kernel: at 512-bit chunks five 43 KB blocks share an SM if it
  // gives shared memory all it can; above 48 KB a block has to opt in
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        phase_a_kernel<Memo>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(phase_a_kernel<Memo>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  phase_a_kernel<Memo><<<(nc + threads - 1) / threads, threads, shared, stream>>>(
      wext, count_t, cnt_out, exit_out, nc, chunk_bits, maxl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bmh_phase_a(const void* wext, const void* count_t, void* cnt_out,
                           void* exit_out, int nc, int chunk_bits, int maxl,
                           void* stream) {
  if (nc <= 0) return static_cast<int>(cudaGetLastError());
  // a memo entry is 5 bits of gap and the rest of codewords completed, which
  // are at most chunk_bits + 32: 16 bits do up to 2047 of them
  const auto launch = chunk_bits + kGaps < (1 << 11) ? launch_phase_a<uint16_t>
                                                     : launch_phase_a<uint32_t>;
  return launch(static_cast<const uint32_t*>(wext),
                static_cast<const int32_t*>(count_t),
                static_cast<int32_t*>(cnt_out), static_cast<int32_t*>(exit_out),
                nc, chunk_bits, maxl, static_cast<cudaStream_t>(stream));
}

extern "C" int bmh_phase_b(const void* wext, const void* count_t,
                           const void* entry, void* idx_out, int nc,
                           int chunk_bits, int maxl, void* stream) {
  if (nc > 0) {
    const int blocks = (nc + kThreads - 1) / kThreads;
    phase_b_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(wext), static_cast<const int32_t*>(count_t),
        static_cast<const int32_t*>(entry), static_cast<int32_t*>(idx_out), nc,
        chunk_bits, maxl);
  }
  return static_cast<int>(cudaGetLastError());
}
