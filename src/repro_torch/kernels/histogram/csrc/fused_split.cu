// Fused split search for the device growth engine, for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_split_pallas
// (src/repro/kernels/histogram/fused.py, kernel _fused_kernel). It computes
// the same function: for every frontier slot w and candidate column f, the
// 256-bin histogram of S per-row stats over the rows with slot_of == w;
// then, per split position b ("bins <= b go left"), the gain
// score(left) + score(right) - score(parent) for the stat kind (gh, class,
// moment), masked to -1e30 where either side holds fewer than min_examples
// (the last stat is the count) and at the last bin; then the argmax over
// bins (lowest bin wins; a NaN gain ranks highest, as jnp.argmax ranks it,
// and makes the column's best NaN) and a running best over columns with a
// strict ">" (lowest column wins; a NaN never wins). Output per slot:
// (gain f32, column i32, split_bin = b + 1 i32), and (-1e30, -1, 0) for a
// slot where nothing was scoreable.
//
// Design. The TPU kernel builds histograms as one-hot MXU matmuls, because
// a TPU has no scatter, and takes prefix sums as an upper-triangular matmul.
// A GPU has both, so this is four small launches:
//   1. amax and
//   2. accumulate: the exact 64-bit fixed-point histogram of
//                  hist_accumulate.cuh (shared with histogram.cu), into a
//                  (W, kf, 256, S) int64 buffer in global memory (14.7 MB
//                  at W = 64, kf = 28, S = 4: it stays in the 50 MB L2).
//   3. scan:       one block of 256 threads per (column, slot): an exact
//                  int64 prefix scan over the bins per stat, the gains in
//                  float32 from the exact sums, and the block argmax.
//   4. reduce:     one thread per slot folds the columns in order.
//
// Determinism. Every sum is exact and independent of order
// (hist_accumulate.cuh): two launches on the same inputs give the same
// bits, duplicate columns tie exactly, and near-ties do not flip from run
// to run.
//
// What bounds it on an H100: the bytes it must read (codes N * kf, stats
// N * S * 4, slot N * 4; 4.3 MB at N = 90,000, kf = 28, S = 4, about 1.3 us
// at 3.35 TB/s) are small; launch overhead, the shared-memory atomics (N *
// kf * S per call) and the strided one-byte code loads bound this simple
// version. Left for a later change: one pass over the rows for all slot
// chunks, codes read 16 bytes at a time, and fusing the scan into the
// accumulate blocks.

#include "hist_accumulate.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kGH = 0, kClass = 1, kMoment = 2;

// score(x) of a stat vector whose count (its last stat) is n.
__device__ __forceinline__ float score(const float* x, float n, int S,
                                       int kind, float l2) {
  if (kind == kGH) return 0.5f * (x[0] * x[0]) / ((x[1] + l2) + 1e-12f);
  if (kind == kMoment) return (x[0] * x[0]) / fmaxf(n, 1e-12f);
  const float tot = fmaxf(n, 1e-12f);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxStats - 1; ++c) {
    if (c < S - 1) {
      const float p = x[c] / tot;
      sum = __fadd_rn(sum, __fmul_rn(p, logf(fmaxf(p, 1e-12f))));
    }
  }
  return -n * (-sum);
}

// a ranks before b: NaN first, then larger, then lower index.
__device__ __forceinline__ bool ranks_before(float ga, int ia, float gb,
                                             int ib) {
  const bool na = isnan(ga), nb = isnan(gb);
  if (na != nb) return na;
  if (!na && ga != gb) return ga > gb;
  return ia < ib;
}

__global__ void scan_kernel(const long long* __restrict__ hist, int kf, int S,
                            int n_bins, int kind, float l2,
                            float min_examples, int n_log2,
                            const unsigned* __restrict__ amax_bits,
                            float* __restrict__ col_gain,
                            int* __restrict__ col_bin) {
  __shared__ long long warp_sum[kThreads / 32][kMaxStats];
  __shared__ float best_g[kThreads / 32];
  __shared__ int best_i[kThreads / 32];
  const int f = blockIdx.x, w = blockIdx.y, b = threadIdx.x;
  const int lane = b & 31, warp = b >> 5;
  const long long* h = hist + (((long long)w * kf + f) * kBins + b) * S;

  long long v[kMaxStats];
#pragma unroll
  for (int s = 0; s < kMaxStats; ++s) {
    v[s] = 0;
    if (s >= S) continue;  // S is the same in every thread
    long long x = h[s];
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    v[s] = x;
    if (lane == 31) warp_sum[warp][s] = x;
  }
  __syncthreads();

  // left = inclusive prefix, right = parent - left, exact in int64; then
  // float32 values of the exact sums
  float L[kMaxStats], R[kMaxStats], P[kMaxStats];
  float Ln = 0.0f, Rn = 0.0f, Pn = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxStats; ++s) {
    L[s] = R[s] = P[s] = 0.0f;
    if (s >= S) continue;
    long long before = 0, total = 0;
    for (int k = 0; k < kThreads / 32; ++k) {
      const long long t = warp_sum[k][s];
      if (k < warp) before += t;
      total += t;
    }
    const long long left = v[s] + before;
    const double inv = 1.0 / stat_scale(amax_bits[s], n_log2);
    L[s] = __double2float_rn((double)left * inv);
    R[s] = __double2float_rn((double)(total - left) * inv);
    P[s] = __double2float_rn((double)total * inv);
    if (s == S - 1) Ln = L[s], Rn = R[s], Pn = P[s];
  }

  float g = (score(L, Ln, S, kind, l2) + score(R, Rn, S, kind, l2)) -
            score(P, Pn, S, kind, l2);
  const bool ok = Ln >= min_examples && Rn >= min_examples && b < n_bins - 1;
  if (!ok) g = kNegInf;

  int gi = b;
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(0xffffffffu, g, off);
    const int oi = __shfl_down_sync(0xffffffffu, gi, off);
    if (ranks_before(og, oi, g, gi)) g = og, gi = oi;
  }
  if (lane == 0) best_g[warp] = g, best_i[warp] = gi;
  __syncthreads();
  if (b == 0) {
    for (int k = 1; k < kThreads / 32; ++k)
      if (ranks_before(best_g[k], best_i[k], g, gi)) g = best_g[k], gi = best_i[k];
    col_gain[(long long)w * kf + f] = g;
    col_bin[(long long)w * kf + f] = gi;
  }
}

__global__ void reduce_kernel(const float* __restrict__ col_gain,
                              const int* __restrict__ col_bin, int kf, int W,
                              float* __restrict__ gain, int* __restrict__ column,
                              int* __restrict__ split_bin) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  float best = kNegInf;
  int col = -1, bin = 0;
  for (int f = 0; f < kf; ++f) {
    const float g = col_gain[(long long)w * kf + f];
    if (g > best) best = g, col = f, bin = col_bin[(long long)w * kf + f] + 1;
  }
  gain[w] = best;
  column[w] = col;
  split_bin[w] = bin;
}

}  // namespace

// Scratch bytes the caller provides: the int64 histogram and the stat maxima.
extern "C" long long fused_split_scratch_bytes(int kf, int S, int W) {
  return ((long long)W * kf * kBins * S + S) * 8;
}

// Launches on `stream` and returns the first CUDA error (0 on success). The
// caller has checked shapes, types and contiguity, 1 <= S <= 16 (S >= 2),
// kf >= 1, 1 <= W <= 65535, 1 <= n_bins <= 256, and that the stats are
// finite; `scratch` holds fused_split_scratch_bytes(kf, S, W) bytes and
// col_gain / col_bin hold W * kf values.
extern "C" int fused_split(const uint8_t* codes, const float* stats,
                           const int* slot_of, int N, int kf, int S, int W,
                           int n_bins, int kind, float l2, float min_examples,
                           void* scratch, float* col_gain, int* col_bin,
                           float* gain, int* column, int* split_bin,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* hist = static_cast<unsigned long long*>(scratch);
  const long long cells = (long long)W * kf * kBins * S;
  unsigned* amax = reinterpret_cast<unsigned*>(hist + cells);
  cudaError_t err = cudaMemsetAsync(scratch, 0,
                                    fused_split_scratch_bytes(kf, S, W), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_log2 = rows_log2(N);  // N < 2^n_log2
  if (N > 0) {
    err = accumulate(codes, stats, slot_of, N, kf, S, W, n_bins, n_log2, amax,
                     hist, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  scan_kernel<<<dim3(kf, W), kThreads, 0, st>>>(
      reinterpret_cast<const long long*>(hist), kf, S, n_bins, kind, l2,
      min_examples, n_log2, amax, col_gain, col_bin);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<(W + 127) / 128, 128, 0, st>>>(col_gain, col_bin, kf, W,
                                                 gain, column, split_bin);
  return static_cast<int>(cudaGetLastError());
}
