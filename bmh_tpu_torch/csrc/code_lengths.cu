// Kernel K6: optimal (Huffman) code lengths of a batch of 257-bin histograms.
//
// Replaces no TPU kernel.  bmh_tpu computes these lengths with a lax.scan of
// 256 two-queue merge steps (bmh_tpu/ops/huffman.py code_lengths_device),
// which XLA compiles into one loop on the device.  The port's plain version
// (ops/huffman.py code_lengths_plain) writes the same steps out over the
// batch: inside the captured compress program that is one graph of 13,360
// small device operations, 18.70 ms a replay on an H100 at (32, 257), for
// work worth microseconds.  This kernel does the same work in one launch.
//
// What bounds it: not bytes (257 int64 counts in and 257 int64 lengths out
// a row, 132 KB for 32 rows: 0.04 us at 3.35 TB/s) nor operations, but one
// dependent chain a row.  Each merge reads the queues the merge before it
// left, so a row cannot finish before its s - 1 merges (s its present
// symbols, at most 257) times the latency of one merge: two picks, each a
// compare and a select after the shared-memory loads of the queue heads,
// some 80-100 cycles a merge, about 15 us for 256 merges at 1.7 GHz.  The rows
// run side by side, one block each.
//
// The design, each step equal to the plain version's:
//   1. A block per row, 256 threads.  The counts go to shared memory; an
//      absent symbol (count <= 0) weighs 2^30, the plain version's _BIG.
//   2. The leaves are ranked in parallel by (weight, symbol): each thread
//      counts the lighter leaves and the equal ones of lower symbol, which
//      is the plain version's stable sort.
//   3. One thread runs the two-queue merge: pop-min prefers the leaf on
//      equal weight, internal nodes are queued in birth order.  A pick
//      loads both queue heads from shared memory (two independent loads).
//      Only s - 1 steps run, since the plain version's later steps leave
//      the row as it is: the work follows the row's present symbols.  Node
//      a + t is born at step t; its children point to it.  (A version that
//      kept the heads' weights in registers and loaded only the next head
//      of the queue it took from gave suboptimal lengths when built with
//      ptxas -O3 of CUDA 12.8, and right ones at -O0: chip_smoke.py and
//      the card tests hold this one to the plain version.)
//   4. Depths by pointer doubling over the 513 parent links, 9 rounds as in
//      the plain version: each round every thread reads its nodes' links
//      and counts, the block syncs, then writes them.
//   5. Each leaf's depth is written at its symbol.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kA = 257;               // the RLE0 alphabet
constexpr int kNodes = 2 * kA - 1;    // leaves, then internal nodes by birth
constexpr int kThreads = 256;
constexpr int kPerThread = (kNodes + kThreads - 1) / kThreads;
constexpr int kRounds = 9;            // 2^9 links cover the deepest chain
constexpr long long kBig = 1LL << 30;

__global__ void __launch_bounds__(kThreads)
code_lengths_kernel(const int64_t* __restrict__ freqs, int64_t* __restrict__ lens,
                    int64_t freq_stride) {
  __shared__ long long w[kA];          // weight by symbol
  __shared__ long long leafw[kA];      // leaf weights in (weight, symbol) order
  __shared__ short leafsym[kA];        // the symbol of each sorted leaf
  __shared__ long long q2[kA - 1];     // internal node weights by birth
  __shared__ short jump[kNodes];       // parent links, then 2^r-th ancestors
  __shared__ int dist[kNodes];         // proper ancestors counted so far
  __shared__ int present;

  const int tid = threadIdx.x;
  const int64_t* f = freqs + blockIdx.x * freq_stride;
  int64_t* out = lens + static_cast<size_t>(blockIdx.x) * kA;
  if (tid == 0) present = 0;
  __syncthreads();
  int mine = 0;
  for (int x = tid; x < kA; x += kThreads) {
    const long long v = f[x];
    mine += v > 0;
    w[x] = v > 0 ? v : kBig;
  }
  for (int x = tid; x < kNodes; x += kThreads) jump[x] = static_cast<short>(x);
  if (mine) atomicAdd(&present, mine);
  __syncthreads();

  for (int x = tid; x < kA; x += kThreads) {
    const long long v = w[x];
    int r = 0;
    for (int y = 0; y < kA; ++y) {
      const long long u = w[y];
      r += (u < v) | ((u == v) & (y < x));
    }
    leafw[r] = v;
    leafsym[r] = static_cast<short>(x);
  }
  __syncthreads();

  if (tid == 0) {
    const int steps = present - 1;
    int i = 0, j = 0;                  // heads of the leaf and internal queues
    for (int t = 0; t < steps; ++t) {  // the internal nodes born so far: t
      long long sum = 0;
      for (int p = 0; p < 2; ++p) {
        const long long lw = i < kA ? leafw[i] : kBig;
        const long long iw = j < t ? q2[j] : kBig;
        int node;
        if (lw <= iw) {
          sum += lw;
          node = i++;
        } else {
          sum += iw;
          node = kA + j++;
        }
        jump[node] = static_cast<short>(kA + t);  // at most 2(s-1) picks: node < kNodes
      }
      q2[t] = sum;
    }
  }
  __syncthreads();

  for (int x = tid; x < kNodes; x += kThreads) dist[x] = jump[x] != x;
  __syncthreads();
  for (int r = 0; r < kRounds; ++r) {
    int nd[kPerThread];
    short nj[kPerThread];
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int x = tid + c * kThreads;
      if (x < kNodes) {
        const int p = jump[x];
        nd[c] = dist[x] + dist[p];
        nj[c] = jump[p];
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int x = tid + c * kThreads;
      if (x < kNodes) {
        dist[x] = nd[c];
        jump[x] = nj[c];
      }
    }
    __syncthreads();
  }

  for (int x = tid; x < kA; x += kThreads) out[leafsym[x]] = dist[x];
}

}  // namespace

// freqs: b rows of 257 counts, row r at freqs + r * freq_stride (the
// histogram's rows are views of a wider buffer); lens: b x 257, contiguous
extern "C" int bmh_code_lengths(const void* freqs, void* lens, int b,
                                long long freq_stride, void* stream) {
  if (b > 0) {
    code_lengths_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(freqs), static_cast<int64_t*>(lens), freq_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
