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
//   1. amax:       per-stat max |v| over active rows (atomicMax on float
//                  bits, order-free), which sets a power-of-two fixed-point
//                  scale per stat.
//   2. accumulate: grid (column, slot chunk, row split). A block adds its
//                  rows' stats, as 64-bit fixed-point integers, into a
//                  (slot chunk, 256, S) histogram in shared memory, then
//                  adds the non-zero cells into a (W, kf, 256, S) int64
//                  buffer in global memory (14.7 MB at W = 64, kf = 28,
//                  S = 4: it stays in the 50 MB L2).
//   3. scan:       one block of 256 threads per (column, slot): an exact
//                  int64 prefix scan over the bins per stat, the gains in
//                  float32 from the exact sums, and the block argmax.
//   4. reduce:     one thread per slot folds the columns in order.
//
// Determinism. Float atomics add in an order that changes from run to run,
// and then duplicate columns stop tying exactly and near-ties flip split
// structure. Integer addition is associative, so every sum here is exact
// and independent of order: two launches on the same inputs give the same
// bits, and the count channel is exact. Stat s is scaled by
// 2^(62 - e_s - ceil(log2(N + 1))), where max |v_s| < 2^e_s, so no sum of
// N rows can overflow int64 and each value keeps ~45 bits below the largest
// (float32 accumulation keeps 24). The stats must be finite.
//
// What bounds it on an H100: the bytes it must read (codes N * kf, stats
// N * S * 4, slot N * 4; 4.3 MB at N = 90,000, kf = 28, S = 4, about 1.3 us
// at 3.35 TB/s) are small; launch overhead, the shared-memory atomics (N *
// kf * S per call) and the strided one-byte code loads bound this simple
// version. Left for a later change: one pass over the rows for all slot
// chunks, codes read 16 bytes at a time, and fusing the scan into the
// accumulate blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kMaxStats = 16;
constexpr int kThreads = 256;
constexpr int kSharedBudget = 96 * 1024;
constexpr int kTargetBlocks = 4 * 132;
constexpr float kNegInf = -1e30f;
constexpr int kGH = 0, kClass = 1, kMoment = 2;

// Fixed-point scale of a stat whose max |v| has the float bits `bits`.
__device__ __forceinline__ double stat_scale(unsigned bits, int n_log2) {
  const float m = __uint_as_float(bits);
  if (!(m > 0.0f)) return 1.0;
  int e;
  frexpf(m, &e);  // m < 2^e
  return ldexp(1.0, 62 - e - n_log2);
}

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

__global__ void amax_kernel(const float* __restrict__ stats,
                            const int* __restrict__ slot_of, int N, int S,
                            unsigned* __restrict__ amax_bits) {
  float m[kMaxStats];
#pragma unroll
  for (int s = 0; s < kMaxStats; ++s) m[s] = 0.0f;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < N;
       r += (long long)gridDim.x * blockDim.x) {
    if (slot_of[r] < 0) continue;
#pragma unroll
    for (int s = 0; s < kMaxStats; ++s)
      if (s < S) m[s] = fmaxf(m[s], fabsf(stats[r * S + s]));
  }
#pragma unroll
  for (int s = 0; s < kMaxStats; ++s) {
    if (s >= S) break;
    float v = m[s];
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if ((threadIdx.x & 31) == 0) atomicMax(amax_bits + s, __float_as_uint(v));
  }
}

__global__ void accumulate_kernel(const uint8_t* __restrict__ codes,
                                  const float* __restrict__ stats,
                                  const int* __restrict__ slot_of, int N,
                                  int kf, int S, int W, int n_bins,
                                  int w_chunk, long long rows_per_block,
                                  int n_log2,
                                  const unsigned* __restrict__ amax_bits,
                                  unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned long long sh[];  // [w_chunk][256][S]
  const int f = blockIdx.x;
  const int c0 = blockIdx.y * w_chunk;
  const int wc = min(w_chunk, W - c0);
  const long long r0 = blockIdx.z * rows_per_block;
  const long long r1 = min((long long)N, r0 + rows_per_block);
  const int cells = wc * kBins * S;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0ull;
  double scale[kMaxStats];
#pragma unroll
  for (int s = 0; s < kMaxStats; ++s)
    scale[s] = s < S ? stat_scale(amax_bits[s], n_log2) : 1.0;
  __syncthreads();

  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int w = slot_of[r] - c0;
    if (w < 0 || w >= wc) continue;
    const int code = codes[r * kf + f];
    if (code >= n_bins) continue;
    unsigned long long* cell = sh + ((long long)w * kBins + code) * S;
    const float* v = stats + r * S;
#pragma unroll
    for (int s = 0; s < kMaxStats; ++s)
      if (s < S)
        atomicAdd(cell + s, static_cast<unsigned long long>(
                                __double2ll_rn((double)v[s] * scale[s])));
  }
  __syncthreads();

  const long long row = (long long)kBins * S;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long v = sh[i];
    if (v == 0ull) continue;
    const int w = i / row;
    atomicAdd(hist + ((long long)(c0 + w) * kf + f) * row + (i - w * row), v);
  }
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
  int n_log2 = 0;
  while ((1ll << n_log2) <= (long long)N) ++n_log2;  // N < 2^n_log2

  if (N > 0) {
    const int amax_blocks = min((N + kThreads - 1) / kThreads, 2 * 132);
    amax_kernel<<<amax_blocks, kThreads, 0, st>>>(stats, slot_of, N, S, amax);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    const int slot_bytes = kBins * S * 8;
    const int w_chunk = max(1, min(W, kSharedBudget / slot_bytes));
    const int n_chunks = (W + w_chunk - 1) / w_chunk;
    const long long max_splits = ((long long)N + kThreads - 1) / kThreads;
    const long long want = (kTargetBlocks + (long long)kf * n_chunks - 1) /
                           ((long long)kf * n_chunks);
    const int splits = (int)max(1ll, min(min(want, max_splits), 65535ll));
    const long long rows_per_block = ((long long)N + splits - 1) / splits;
    const int smem = w_chunk * slot_bytes;
    err = cudaFuncSetAttribute(accumulate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    accumulate_kernel<<<dim3(kf, n_chunks, splits), kThreads, smem, st>>>(
        codes, stats, slot_of, N, kf, S, W, n_bins, w_chunk, rows_per_block,
        n_log2, amax, hist);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }

  scan_kernel<<<dim3(kf, W), kThreads, 0, st>>>(
      reinterpret_cast<const long long*>(hist), kf, S, n_bins, kind, l2,
      min_examples, n_log2, amax, col_gain, col_bin);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<(W + 127) / 128, 128, 0, st>>>(col_gain, col_bin, kf, W,
                                                 gain, column, split_bin);
  return static_cast<int>(cudaGetLastError());
}
