// Exact histogram accumulation for Hopper (sm_90a), shared by the
// split-search kernel (fused_split.cu) and the histogram kernel
// (histogram.cu).
//
// For rows r with slot_of[r] in [0, W) and codes[r, f] < n_bins, it adds
// stats[r, :] into the cell (slot_of[r], f, codes[r, f]) of an int64
// (W, kf, 256, S) histogram in global memory, in two launches:
//   1. amax:       per-stat max |v| over active rows (atomicMax on float
//                  bits, order-free), which sets a power-of-two fixed-point
//                  scale per stat.
//   2. accumulate: grid (column, slot chunk, row split). A block adds its
//                  rows' stats, as 64-bit fixed-point integers, into a
//                  (slot chunk, 256, S) histogram in shared memory, then
//                  adds the non-zero cells into the global histogram.
// The caller zeroes the histogram and the S maxima first.
//
// Determinism. Float atomics add in an order that changes from run to run.
// Integer addition is associative, so every sum here is exact and
// independent of order: two launches on the same inputs give the same bits,
// and the count channel is exact. Stat s is scaled by 2^stat_shift =
// 2^(62 - e_s - ceil(log2(N + 1))), where max |v_s| < 2^e_s, so no sum of N
// rows can overflow int64 and each value keeps ~45 bits below the largest
// (float32 accumulation keeps 24). The stats must be finite.
//
// Shared memory: a slot takes 256 * S * 8 bytes (8 KB at S = 4), so slots go
// in chunks of up to kSharedBudget (96 KB: 12 slots at S = 4), one grid axis
// over the chunks; 32 slots would need 256 KB, more than a block's 227 KB.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kMaxStats = 16;
constexpr int kThreads = 256;
constexpr int kSharedBudget = 96 * 1024;
constexpr int kTargetBlocks = 4 * 132;

// log2 of the fixed-point scale of a stat whose max |v| has the float bits
// `bits` (0 when the max is 0).
__device__ __forceinline__ int stat_shift(unsigned bits, int n_log2) {
  const float m = __uint_as_float(bits);
  if (!(m > 0.0f)) return 0;
  int e;
  frexpf(m, &e);  // m < 2^e
  return 62 - e - n_log2;
}

__device__ __forceinline__ double stat_scale(unsigned bits, int n_log2) {
  return ldexp(1.0, stat_shift(bits, n_log2));
}

// The smallest n_log2 with N < 2^n_log2.
inline int rows_log2(long long N) {
  int n_log2 = 0;
  while ((1ll << n_log2) <= N) ++n_log2;
  return n_log2;
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

// Launches amax and accumulate on `st` for N > 0 rows; `hist` and `amax`
// are zeroed. Returns the first CUDA error (cudaSuccess on success).
inline cudaError_t accumulate(const uint8_t* codes, const float* stats,
                              const int* slot_of, int N, int kf, int S, int W,
                              int n_bins, int n_log2, unsigned* amax,
                              unsigned long long* hist, cudaStream_t st) {
  cudaError_t err;
  const int amax_blocks = min((N + kThreads - 1) / kThreads, 2 * 132);
  amax_kernel<<<amax_blocks, kThreads, 0, st>>>(stats, slot_of, N, S, amax);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

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
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  accumulate_kernel<<<dim3(kf, n_chunks, splits), kThreads, smem, st>>>(
      codes, stats, slot_of, N, kf, S, W, n_bins, w_chunk, rows_per_block,
      n_log2, amax, hist);
  return cudaGetLastError();
}

}  // namespace
