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
//   K2: from the chunk's true entry gap, the canonical index of every
//       completed codeword (or -1) per step, time-major (steps, NC).
//
// What bounds them: a dependent chain.  A turn of either is a handful of
// integer operations, each waiting for the turn before it; the bytes
// (4 (wpc + 1) of words and 128 of counts in, 256 out per chunk for K1;
// K2's (steps, NC) int32 output) and the operations are small beside the
// chain's latency times its length.  Both run one thread per chunk, a warp
// of consecutive chunks a block (K1 fewer where its shared memory runs
// short).
//
// A turn is a codeword, not a bit (both kernels).  The FSM completes at the
// first length l with count[l] > 0 and prefix_l < sum_{k<=l} count[k]
// 2^(l-k) (by induction r stays >= 0 for counts >= 0), that is with the
// 32-bit window w at p below lim[l] = sum_{k<=l} count[k] 2^(32-k).  lim
// rises with l, so the length is 1 + #{l <= maxl : w >= lim[l]}, and
// maxl + 1 of them mean the overflow reset (a boundary that counts no
// symbol).  A thread holds lim[1..31] in registers (halved, so that a full
// code space fits 32 bits; saturated, so that an over-subscribed table
// completes where the FSM does) and finds a length by independent compares,
// not by up to 31 dependent FSM steps.  A codeword that would end past
// chunk_bits + 32 ends the decode as the FSM's running out of bits does.
//
// What K1's design does about the chain:
//   * It walks every distinct decode once.  From a boundary at bit p the
//     rest of a decode depends on p alone, so two gaps whose decodes reach
//     one boundary are one decode from there, and on real payloads a
//     chunk's 32 decodes merge within a few codewords.  The thread takes
//     the gaps from 31 down to 0.  Where a gap's decode lands it looks the
//     position up in a per-chunk memo: a bitmap of visited positions and,
//     per position, the gap that first came by and the codewords it had
//     completed until there.  On a visited position the gap is finished:
//     its count is its own so far plus what that earlier gap completed from
//     there on, its exit gap is that gap's.  Every turn of the loop
//     therefore decodes at a position nobody has visited, and a chunk costs
//     at most chunk_bits + 32 turns whatever the table: nothing is left of
//     the 32-fold walk, not even under a table that lets no two decodes
//     meet.
//   * What a turn waits for is loaded together: the words under the next
//     position, its visited bit and its memo entry all depend on that
//     position alone.
//   * The memo, the chunk's words (wpc + 1 and two of zeros) and the
//     per-gap totals lie in shared memory, every array laid out
//     [index][thread], in blocks of as many chunks as fit (a warp up to
//     1984-bit chunks, one chunk from 27296 bits on).  Where even one
//     chunk's arrays do not fit (from 54656 bits on) they lie in a
//     global scratch buffer that the wrapper allocates, each chunk's arrays
//     one contiguous span, in blocks of a warp: the same loop at any chunk
//     size.
//
// What K2's design does about the chain and its 4 (chunk_bits + 32) bytes
// of output a chunk, most of them -1:
//   * A turn decodes a codeword by K1's compares, up to the bucket of maxl
//     the batch needs (8, 16, 24 or 31: one instantiation each), and emits
//     its index o + r' = prefix_l + base[l], base[l] = min(o_l, 256) - F_l
//     with o_l = sum_{k<l} count[k] and F_l = sum_{k<l} count[k] 2^(l-k),
//     both mod 2^32: wherever a codeword completes, 0 <= prefix_l - F_l <
//     count[l], so the 32-bit sum is exact and its clip to 256 is the
//     FSM's.  base[l] is one shared-memory load a codeword; the index is
//     stored one turn late, so that the load arrives while the next
//     codeword's compares run (a warp issues in order: a store right after
//     the load would wait for it every turn).
//   * The words come from device memory three ahead: a turn moves at most
//     32 bits, so it crosses at most one word, and the load of the word
//     after next is issued when the turn crosses.
//   * The -1 fill leaves the chain.  Each thread owns a column of a window
//     of 128 steps in shared memory, pre-filled with -1, and writes there
//     only the indices of the codewords that end inside the window.  When
//     the window is full the warp stores it 16 bytes a lane, four rows an
//     instruction, with streaming stores, refills it with -1 and decodes
//     on while the stores drain.  The output's rows are padded to a
//     multiple of 32 chunks (the wrapper returns the (steps, NC) view), so
//     that a warp's part of a row is one aligned 128-byte line: stored 4
//     bytes a lane into unaligned rows, the writes alone ran far below the
//     rate of a fill of the same bytes (PERF.md, PR 5).  Lanes past the
//     last chunk decode nothing and help store.  Windows iterate over the
//     steps, so no chunk size is too long.
// The TPU's unrolled compare-select over lengths and its (32, TILE) plane of
// lanes in lock-step exist only because its vector unit can neither gather
// nor branch per lane.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGaps = 32;
constexpr int kMaxLen = 31;
constexpr int kAmax = 256;
// chunks a block (a warp) of either kernel; K1: the shared memory a block
// may opt in to; K2: the steps a thread's output window holds
constexpr int kChunkThreads = 32;
constexpr int kMaxShared = 232448;
constexpr int kWindow = 128;
// cards whose K1 attributes launch_phase_a remembers having set
constexpr int kMaxDevices = 64;

// lim[l] = min(sum_{k<=l} count[k] 2^(31-k), 2^31) up to maxl; above it
// 2^31, which no halved window reaches
template <int kL>
__device__ __forceinline__ void code_limits(const int32_t* count_t, int nc, int c,
                                            int maxl, uint32_t (&lim)[kL + 1]) {
  unsigned long long acc = 0;
#pragma unroll
  for (int l = 1; l <= kL; ++l) {
    const int cnt = count_t[static_cast<size_t>(l) * nc + c];
    acc = min(acc + (static_cast<unsigned long long>(max(cnt, 0)) << (31 - l)), 1ull << 31);
    lim[l] = l <= maxl ? static_cast<uint32_t>(acc) : 1u << 31;
  }
}

// the length of the codeword at the head of a 32-bit window (maxl + 1: the
// overflow reset).  half and lim[l] lie in [0, 2^31], so the sign of
// half - lim[l] says half < lim[l]: a subtract and a shift-add a length,
// in four independent sums
template <int kL>
__device__ __forceinline__ int code_length(uint32_t window, const uint32_t (&lim)[kL + 1]) {
  const uint32_t half = window >> 1;
  int below[4] = {0, 0, 0, 0};
#pragma unroll
  for (int l = 1; l <= kL; ++l) below[l & 3] += (half - lim[l]) >> 31;
  return 1 + kL - ((below[0] + below[1]) + (below[2] + below[3]));
}

// K1's bytes for `threads` chunks, every array laid out [index][thread]:
// totals[32] (per finished gap, count << 5 | exit gap), words[wpc + 3],
// seen[] (bitmap over bit positions 0 .. chunk_bits + 32), memo[positions]
// of Memo (gap << kShift | codewords completed until there).
template <typename Memo>
__host__ __device__ constexpr size_t phase_a_bytes(int chunk_bits, int threads) {
  const size_t positions = chunk_bits + kGaps + 1;
  const size_t words = chunk_bits / 32 + 3;
  return threads * (4 * (kGaps + words + (positions + 31) / 32) + sizeof(Memo) * positions);
}

// K1's global scratch a chunk, in 32-bit words
template <typename Memo>
__host__ __device__ constexpr size_t phase_a_chunk_words(int chunk_bits) {
  return (phase_a_bytes<Memo>(chunk_bits, 1) + 3) / 4;
}

// kShared: the arrays lie in shared memory, the block's chunks interleaved
// (index stride = threads); else in `scratch`, a span of stride 1 a chunk
template <typename Memo, bool kShared>
__global__ void phase_a_kernel(const uint32_t* __restrict__ wext,
                               const int32_t* __restrict__ count_t,
                               int32_t* __restrict__ cnt_out,
                               int32_t* __restrict__ exit_out,
                               uint32_t* __restrict__ scratch,
                               int nc, int chunk_bits, int maxl) {
  constexpr int kShift = 8 * sizeof(Memo) - 5;
  extern __shared__ uint32_t shared[];
  const int tid = threadIdx.x;
  const int c = blockIdx.x * blockDim.x + tid;
  if (c >= nc) return;  // no block-wide barrier below
  const int steps = chunk_bits + kGaps;
  const int seen_words = (steps + 1 + 31) / 32;
  const int wrows = chunk_bits / 32 + 1;
  const int stride = kShared ? static_cast<int>(blockDim.x) : 1;
  const int lane = kShared ? tid : 0;
  uint32_t* own = kShared ? shared + tid
                          : scratch + static_cast<size_t>(c) * phase_a_chunk_words<Memo>(chunk_bits);
  int32_t* tot_s = reinterpret_cast<int32_t*>(own);
  uint32_t* word_s = own + kGaps * stride;
  uint32_t* seen_s = word_s + (wrows + 2) * stride;
  Memo* memo_s = reinterpret_cast<Memo*>(seen_s + seen_words * stride - lane) + lane;
  uint32_t lim[kMaxLen + 1];
  code_limits<kMaxLen>(count_t, nc, c, maxl, lim);
  for (int w = 0; w < wrows; ++w)
    word_s[w * stride] = wext[static_cast<size_t>(w) * nc + c];
  word_s[wrows * stride] = 0;
  word_s[(wrows + 1) * stride] = 0;
  for (int w = 0; w < seen_words; ++w) seen_s[w * stride] = 0;

  // every turn decodes the codeword at t, a position below steps that is
  // marked and that no earlier turn has decoded at
  int g = kGaps - 1, t = g, done = 0;
  seen_s[0] = 1u << t;
  memo_s[t * stride] = static_cast<Memo>(static_cast<uint32_t>(g) << kShift);
  uint32_t w0 = word_s[0], w1 = word_s[stride];
  while (g >= 0) {
    const int len = code_length<kMaxLen>(__funnelshift_l(w1, w0, t & 31), lim);
    t += len;
    // what the next turn needs, and what tells whether there is one
    const int at = min(t, steps);
    const uint32_t seen = seen_s[(at >> 5) * stride];
    const uint32_t memo = memo_s[at * stride];
    uint32_t next_w0 = word_s[(at >> 5) * stride];
    uint32_t next_w1 = word_s[((at >> 5) + 1) * stride];
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
          const int32_t tot = tot_s[(memo >> kShift) * stride];
          total = done + (tot >> 5) - static_cast<int>(memo & ((1u << kShift) - 1));
          ex = tot & 31;
        } else {
          finished = false;
          seen_s[(t >> 5) * stride] = seen | bit;
          memo_s[t * stride] = static_cast<Memo>((static_cast<uint32_t>(g) << kShift) | done);
        }
      }
    }
    if (finished) {
      tot_s[g * stride] = (total << 5) | ex;
      const size_t o = static_cast<size_t>(g) * nc + c;
      cnt_out[o] = total;
      exit_out[o] = ex;
      --g;
      // position g is new: only decodes entering at lower gaps can come by
      t = max(g, 0);
      done = 0;
      seen_s[0] |= 1u << t;
      memo_s[t * stride] = static_cast<Memo>(static_cast<uint32_t>(t) << kShift);
      next_w0 = word_s[0];
      next_w1 = word_s[stride];
    }
    w0 = next_w0;
    w1 = next_w1;
  }
}

// shared-memory accesses by a 32-bit address computed once: through a
// generic pointer the compiler rebuilds the block's shared-memory base
// every turn of K2's loop
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// compares up to length kL >= maxl
template <int kL>
__global__ void __launch_bounds__(kChunkThreads)
phase_b_kernel(const uint32_t* __restrict__ wext, const int32_t* __restrict__ count_t,
               const int32_t* __restrict__ entry, int32_t* __restrict__ idx_out,
               int nc, int ld, int chunk_bits, int maxl) {
  __shared__ __align__(16) int32_t window_s[kWindow][kChunkThreads];
  __shared__ uint32_t base_s[kL + 2][kChunkThreads];  // row kL + 1: overflow, unused
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kChunkThreads;
  // a lane past the last chunk decodes nothing (the last chunk's table
  // stands in for its own) and helps store the window
  const int c = min(c0 + lane, nc - 1);
  const bool live = c0 + lane < nc;
  const int steps = chunk_bits + kGaps;
  const int last_row = chunk_bits / 32;  // wext's rows are 0 .. last_row
  uint32_t lim[kL + 1];
  code_limits<kL>(count_t, nc, c, maxl, lim);
  // base[l] = min(o_l, 256) - F_l; o saturates at 256, F wraps mod 2^32
  uint32_t first = 0, offset = 0;
#pragma unroll
  for (int l = 1; l <= kL; ++l) {
    const uint32_t cnt = max(count_t[static_cast<size_t>(l) * nc + c], 0);
    base_s[l][lane] = offset - first;
    first = 2u * (first + cnt);
    offset = min(offset + min(cnt, static_cast<uint32_t>(kAmax)), static_cast<uint32_t>(kAmax));
  }
  for (int r = 0; r < kWindow; ++r) window_s[r][lane] = -1;

  const uint32_t* col = wext + c;
  auto word = [&](int i) {
    return i <= last_row ? __ldg(col + static_cast<size_t>(i) * nc) : 0u;
  };
  // the FSM is idle before its entry: an entry outside 0 .. steps acts as
  // the nearer end
  int t = live ? min(max(entry[c], 0), steps) : steps, k = t >> 5;
  uint32_t w0 = word(k), w1 = word(k + 1), w2 = word(k + 2);
  uint32_t window = __funnelshift_l(w1, w0, t & 31);
  int len = code_length<kL>(window, lim);
  bool done = false;
  // a codeword's index is stored one turn late, so that its base lookup
  // arrives while the next codeword's compares run: its row in the window
  // (-1: none), prefix and base
  int held_row = -1;
  uint32_t held_prefix = 0, held_base = 0;
  const uint32_t window_at = static_cast<uint32_t>(__cvta_generic_to_shared(&window_s[0][lane]));
  const uint32_t base_at = static_cast<uint32_t>(__cvta_generic_to_shared(&base_s[0][lane]));
  constexpr int kRow = 4 * kChunkThreads;  // bytes a row of either array
  // the window store: a lane moves 16 bytes, the warp 4 rows an instruction
  constexpr int kRowLanes = kChunkThreads / 4;
  const int quad = lane % kRowLanes * 4;
  int32_t* const out = idx_out + c0 + quad;
  for (int row0 = 0; row0 < steps; row0 += kWindow) {
    const int row_end = min(row0 + kWindow, steps);
    while (!done) {
      const int end = t + len;  // one past the codeword's last bit
      if (end > row_end) {  // it ends in a later window, or the bits ran out
        done = end > steps;
        break;
      }
      if (held_row >= 0)
        sts_u32(window_at + held_row * kRow, min(held_prefix + held_base, static_cast<uint32_t>(kAmax)));
      const bool complete = len <= maxl;
      held_row = complete ? end - 1 - row0 : -1;
      held_prefix = window >> (32 - len);
      held_base = lds_u32(base_at + len * kRow);
      if (complete && end >= chunk_bits) {  // the last codeword
        done = true;
        break;
      }
      t = end;
      const bool cross = (t >> 5) > k;
      k += cross;
      w0 = cross ? w1 : w0;
      w1 = cross ? w2 : w1;
      if (cross) w2 = word(k + 2);
      window = __funnelshift_l(w1, w0, t & 31);
      len = code_length<kL>(window, lim);
    }
    if (held_row >= 0) {
      sts_u32(window_at + held_row * kRow, min(held_prefix + held_base, static_cast<uint32_t>(kAmax)));
      held_row = -1;
    }
    __syncwarp();
    for (int r = lane / kRowLanes; r < row_end - row0; r += 4) {
      int4* const cell = reinterpret_cast<int4*>(&window_s[r][quad]);
      __stcs(reinterpret_cast<int4*>(out + static_cast<size_t>(row0 + r) * ld), *cell);
      *cell = make_int4(-1, -1, -1, -1);
    }
    __syncwarp();
  }
}

// chunks a block of K1 keeps in shared memory: as many as fit, at most a
// warp; 0 where one chunk's arrays do not fit
template <typename Memo>
int phase_a_threads(int chunk_bits) {
  int threads = kChunkThreads;
  while (threads > 1 && phase_a_bytes<Memo>(chunk_bits, threads) > kMaxShared) threads /= 2;
  return phase_a_bytes<Memo>(chunk_bits, threads) <= kMaxShared ? threads : 0;
}

template <typename Memo>
size_t phase_a_scratch(int nc, int chunk_bits) {
  return phase_a_threads<Memo>(chunk_bits) > 0
             ? 0
             : static_cast<size_t>(nc) * 4 * phase_a_chunk_words<Memo>(chunk_bits);
}

template <typename Memo>
int launch_phase_a(const uint32_t* wext, const int32_t* count_t, int32_t* cnt_out,
                   int32_t* exit_out, uint32_t* scratch, int nc, int chunk_bits,
                   int maxl, cudaStream_t stream) {
  const int threads = phase_a_threads<Memo>(chunk_bits);
  if (threads == 0) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    phase_a_kernel<Memo, false><<<(nc + kChunkThreads - 1) / kChunkThreads,
                                  kChunkThreads, 0, stream>>>(
        wext, count_t, cnt_out, exit_out, scratch, nc, chunk_bits, maxl);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t shared = phase_a_bytes<Memo>(chunk_bits, threads);
  // once per kernel and card (the attributes belong to the current
  // device): at 512-bit chunks five 43 KB blocks share an SM if it gives
  // shared memory all it can; above 48 KB a block has to opt in.  Setting
  // them twice, from two threads at once, is harmless.
  static std::atomic<bool> configured[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !configured[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        phase_a_kernel<Memo, true>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(phase_a_kernel<Memo, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) configured[dev].store(true, std::memory_order_release);
  }
  phase_a_kernel<Memo, true><<<(nc + threads - 1) / threads, threads, shared, stream>>>(
      wext, count_t, cnt_out, exit_out, nullptr, nc, chunk_bits, maxl);
  return static_cast<int>(cudaGetLastError());
}

// a memo entry is 5 bits of gap and the rest of codewords completed, which
// are at most chunk_bits + 32: 16 bits do up to 2047 of them, 32 bits up to
// 2^27 - 1 (and a total, count << 5 | exit gap, up to 2^26 - 1).  That
// covers chunks of up to about 2^26 bits, more than any block's payload
// (2 MiB of symbols of at most 31 bits each is under 2^26 bits).
template <typename Fn>
auto with_memo(int chunk_bits, Fn fn) {
  return chunk_bits + kGaps < (1 << 11) ? fn(uint16_t{}) : fn(uint32_t{});
}

template <int kL>
int launch_phase_b(const uint32_t* wext, const int32_t* count_t, const int32_t* entry,
                   int32_t* idx_out, int nc, int ld, int chunk_bits, int maxl,
                   cudaStream_t stream) {
  phase_b_kernel<kL><<<(nc + kChunkThreads - 1) / kChunkThreads, kChunkThreads, 0, stream>>>(
      wext, count_t, entry, idx_out, nc, ld, chunk_bits, maxl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bytes of global scratch bmh_phase_a needs at this chunk size (0: none)
extern "C" size_t bmh_phase_a_scratch_bytes(int nc, int chunk_bits) {
  return with_memo(chunk_bits, [&](auto memo) {
    return phase_a_scratch<decltype(memo)>(nc, chunk_bits);
  });
}

extern "C" int bmh_phase_a(const void* wext, const void* count_t, void* cnt_out,
                           void* exit_out, void* scratch, int nc, int chunk_bits,
                           int maxl, void* stream) {
  if (nc <= 0) return static_cast<int>(cudaGetLastError());
  return with_memo(chunk_bits, [&](auto memo) {
    return launch_phase_a<decltype(memo)>(
        static_cast<const uint32_t*>(wext), static_cast<const int32_t*>(count_t),
        static_cast<int32_t*>(cnt_out), static_cast<int32_t*>(exit_out),
        static_cast<uint32_t*>(scratch), nc, chunk_bits, maxl,
        static_cast<cudaStream_t>(stream));
  });
}

// idx_out: rows of ld >= nc int32, ld a multiple of 32 (a warp's chunks
// are one aligned 128-byte line of a row), 16-byte aligned
extern "C" int bmh_phase_b(const void* wext, const void* count_t,
                           const void* entry, void* idx_out, int nc, int ld,
                           int chunk_bits, int maxl, void* stream) {
  if (nc <= 0) return static_cast<int>(cudaGetLastError());
  if (ld < nc || ld % kChunkThreads || reinterpret_cast<uintptr_t>(idx_out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = maxl <= 8    ? launch_phase_b<8>
                      : maxl <= 16 ? launch_phase_b<16>
                      : maxl <= 24 ? launch_phase_b<24>
                                   : launch_phase_b<kMaxLen>;
  return launch(static_cast<const uint32_t*>(wext), static_cast<const int32_t*>(count_t),
                static_cast<const int32_t*>(entry), static_cast<int32_t*>(idx_out), nc, ld,
                chunk_bits, maxl, static_cast<cudaStream_t>(stream));
}
