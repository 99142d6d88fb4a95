// Full per-node histogram for the batched growth engine, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel histogram_pallas
// (src/repro/kernels/histogram/histogram.py, kernel _hist_kernel). It
// computes the same function:
//   out[n, f, b, s] = sum of stats[i, s] over the rows i with
//                     node_of[i] == n and codes[i, f] == b,
// rows with node -1 dropped; out is (n_nodes, F, n_bins, S) float32.
//
// Design. The TPU kernel builds the histogram as one-hot MXU matmuls,
// because a TPU has no scatter. A GPU has one, so this is the exact
// accumulation core of the split-search kernel (hist_accumulate.cuh: a
// per-stat max |v| sets a power-of-two fixed-point scale, then blocks of
// (column, node chunk, row split) add int64 values into shared memory and
// flush the non-zero cells into an int64 (n_nodes, F, 256, S) buffer), and
// a last pass that writes the float32 value of each exact sum. The sums are
// exact and order-free, so two launches give the same bits, the count
// channel is exact, and each output is the correctly rounded float32 of the
// sum of the fixed-point values (__ll2float_rn, then an exact power-of-two
// scale).
//
// What bounds it on an H100: the bytes it must move (codes N * F, stats
// N * S * 4, node_of N * 4 read once, the float32 output written once:
// 7.8 MB at N = 90,000, F = 28, S = 4, n_nodes = 32, about 2.3 us at
// 3.35 TB/s) are small; launch overhead, the shared-memory atomics (N * F *
// S per call), the strided one-byte code loads and one pass over the rows
// per node chunk bound this simple version.

#include "hist_accumulate.cuh"

namespace {

__global__ void convert_kernel(const long long* __restrict__ hist,
                               const unsigned* __restrict__ amax_bits,
                               long long n_rows, int S, int n_bins,
                               int n_log2, float* __restrict__ out) {
  // n_rows = n_nodes * F histogram rows of n_bins * S outputs each
  const long long total = n_rows * n_bins * S;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int s = (int)(i % S);
    const long long rb = i / S;
    const int b = (int)(rb % n_bins);
    const long long row = rb / n_bins;
    const long long v = hist[(row * kBins + b) * S + s];
    out[i] = ldexpf(__ll2float_rn(v), -stat_shift(amax_bits[s], n_log2));
  }
}

}  // namespace

// Scratch bytes the caller provides: the int64 histogram and the stat maxima.
extern "C" long long histogram_scratch_bytes(int F, int S, int n_nodes) {
  return ((long long)n_nodes * F * kBins * S + S) * 8;
}

// Launches on `stream` and returns the first CUDA error (0 on success). The
// caller has checked shapes, types and contiguity, N >= 1, F >= 1,
// 1 <= S <= 16, 1 <= n_nodes <= 65535, 1 <= n_bins <= 256, node_of in
// [-1, n_nodes), and that the stats are finite; `scratch` holds
// histogram_scratch_bytes(F, S, n_nodes) bytes and `out` n_nodes * F *
// n_bins * S floats.
extern "C" int histogram(const uint8_t* codes, const float* stats,
                         const int* node_of, int N, int F, int S, int n_nodes,
                         int n_bins, void* scratch, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* hist = static_cast<unsigned long long*>(scratch);
  const long long cells = (long long)n_nodes * F * kBins * S;
  unsigned* amax = reinterpret_cast<unsigned*>(hist + cells);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, histogram_scratch_bytes(F, S, n_nodes), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_log2 = rows_log2(N);  // N < 2^n_log2
  err = accumulate(codes, stats, node_of, N, F, S, n_nodes, n_bins, n_log2,
                   amax, hist, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n_rows = (long long)n_nodes * F;
  const long long total = n_rows * n_bins * S;
  const int blocks = (int)min((total + kThreads - 1) / kThreads, 8ll * 132);
  convert_kernel<<<blocks, kThreads, 0, st>>>(
      reinterpret_cast<const long long*>(hist), amax, n_rows, S, n_bins,
      n_log2, out);
  return static_cast<int>(cudaGetLastError());
}
