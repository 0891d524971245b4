// Kernels K1 and K2: the canonical-Huffman gap decode.
//
// Replace bmh_tpu/ops/pallas_decode.py phase_a / _phase_a_kernel (K1) and
// phase_b / _phase_b_kernel (K2).  The payload of a batch is cut into
// chunks of chunk_bits bits.  Both kernels run the canonical FSM
//     r' = 2 (r - c) + bit,   complete  <=>  0 <= r' < count[len + 1]
// (c = count[len], emitted canonical index = o + r' with o the running
// offset) over chunk_bits + 32 bits of each chunk.
//   K1: one thread per (gap, chunk) lane; entering the chunk at each of the
//       32 possible codeword-boundary offsets, it counts completed symbols
//       and records the exit gap (where decoding crosses the chunk end).
//   K2: one thread per chunk; from the chunk's true entry gap it re-decodes
//       and writes the canonical index of every completed codeword (or -1)
//       per step, time-major (steps, NC).
//
// What bounds them: operations.  K1 runs 32 * NC * (chunk_bits + 32) FSM
// steps of a handful of integer ops each over 4 * (wpc + 1) bytes of words
// per chunk; K2's bytes are its (steps, NC) int32 output, written once.
//
// What the design does about it: bits are read straight from the packed
// words (one 32-bit load per 32 steps, held in a register) and the
// chunk's per-length count table is indexed directly from shared memory
// (laid out [length][thread], conflict-free).  The TPU's unrolled
// compare-select over lengths exists only because its vector unit cannot
// gather; here the lookup is one load.  A K1 lane stops as soon as it has
// found its exit gap.  Warps run over consecutive chunks, so the word
// loads of a step and K2's output stores are contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGaps = 32;
constexpr int kMaxLen = 31;
constexpr int kAmax = 256;
constexpr int kThreads = 128;

__device__ __forceinline__ void load_counts(int32_t (*cnt_s)[kThreads],
                                            const int32_t* count_t, int nc,
                                            int c) {
  for (int l = 0; l <= kMaxLen; ++l)
    cnt_s[l][threadIdx.x] = count_t[static_cast<size_t>(l) * nc + c];
}

__global__ void phase_a_kernel(const uint32_t* __restrict__ wext,
                               const int32_t* __restrict__ count_t,
                               int32_t* __restrict__ cnt_out,
                               int32_t* __restrict__ exit_out,
                               int nc, int chunk_bits, int maxl) {
  __shared__ int32_t cnt_s[kMaxLen + 1][kThreads];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int g = blockIdx.y;
  if (c >= nc) return;
  load_counts(cnt_s, count_t, nc, c);
  const int wrows = chunk_bits / 32 + 1;
  int r = 0, ln = 0, cc = 0, cnt = 0, ex = -1;
  for (int w = g / 32; w < wrows && ex < 0; ++w) {
    const uint32_t word = wext[static_cast<size_t>(w) * nc + c];
    for (int b = 0; b < 32; ++b) {
      const int t = w * 32 + b;
      if (t < g) continue;
      const int bit = (word >> (31 - b)) & 1;
      const int r_n = 2 * (r - cc) + bit;
      const int ln_n = ln + 1;
      const int c_n = ln_n <= maxl ? cnt_s[ln_n][threadIdx.x] : 0;
      const bool complete = c_n > 0 && r_n >= 0 && r_n < c_n;
      if (complete || ln_n > maxl) {
        r = 0; ln = 0; cc = 0;
      } else {
        r = r_n; ln = ln_n; cc = c_n;
      }
      if (complete) {
        ++cnt;
        if (t + 1 >= chunk_bits) { ex = t + 1 - chunk_bits; break; }
      }
    }
  }
  const size_t o = static_cast<size_t>(g) * nc + c;
  cnt_out[o] = cnt;
  exit_out[o] = ex < 0 ? 0 : (ex > kGaps - 1 ? kGaps - 1 : ex);
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

}  // namespace

extern "C" int bmh_phase_a(const void* wext, const void* count_t, void* cnt_out,
                           void* exit_out, int nc, int chunk_bits, int maxl,
                           void* stream) {
  if (nc > 0) {
    const dim3 grid((nc + kThreads - 1) / kThreads, kGaps);
    phase_a_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(wext), static_cast<const int32_t*>(count_t),
        static_cast<int32_t*>(cnt_out), static_cast<int32_t*>(exit_out), nc,
        chunk_bits, maxl);
  }
  return static_cast<int>(cudaGetLastError());
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
