// The traversal shared by forest_infer.cu (B2, the depth-packed layout) and
// forest_single.cu (B4, the unpacked SoA): a block walks every (example,
// tree) pair of one group of trees over the example tiles of its chunk.
//
// Nodes are 16-byte records (kernels/forest_infer/layout.py): x = the
// column, ~column for a categorical node; y = the threshold's bits, or the
// node's mask index; z = left_child (< 0: leaf); w = the leaf value's bits
// (O == 1) or its row in the leaf table. So a round is one 16-byte load,
// then one float compare or one 32-bit mask-word test. A numerical node
// goes right when x >= threshold, a categorical one when the bit of the
// code of x is set; leaves self-loop in the reference, so the walk stops at
// the first leaf, which is the same function.
//
// Categorical codes follow numpy's float32 -> int64 cast, which the
// reference CPU engines use: NaN, +-inf and |x| >= 2^63 become INT64_MIN,
// which the clip to [0, 255] makes 0. A plain (long long)x would saturate
// +inf to INT64_MAX (code 255) and map NaN to 0, so the rule is written
// out in cat_code.
//
// Two variants, chosen by the host's plan (plan.py) from shapes alone:
//   kStaged = true:  the group's records and masks are copied into shared
//                    memory once per block (16 bytes a thread, coalesced),
//                    trees M + 1 records apart so that equal offsets of
//                    different trees fall in different banks; every round
//                    then reads shared memory;
//   kStaged = false: every round reads its record with a 16-byte __ldg
//                    through L1 / L2.
// The plan stages a group only while the block keeps 4 blocks (32 warps)
// an SM: the walk is latency-bound, and on the H100 a Random Forest tree of
// 4,096 nodes (64 KB) walked from global memory by 4-tree blocks at full
// occupancy beat the same tree staged by 1-tree blocks (chip_smoke.py's
// timings, PERF.md). X is read through L1 (__ldg) in both variants: a
// tile of X staged in shared memory did no better on the card.
//
// What bounds it on an H100: latency and issue, not bytes. A walk is a
// chain of dependent loads (record, x, maybe a mask word) per round; the
// bytes that must move are X, the tables once, and N x T x O floats of
// output. The design keeps the chain in shared memory or L1, keeps many
// warps an SM in flight, and makes a warp's stores whole sectors (pairs
// are numbered trees fastest).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace forest_traverse {

constexpr int kMaskWords = 8;
constexpr int kThreads = 256;       // plan.THREADS
constexpr int kSmemLimit = 232448;  // plan.SMEM_LIMIT

__device__ __forceinline__ int cat_code(float x) {
  if (isnan(x) || x >= 9223372036854775808.0f || x < -9223372036854775808.0f)
    return 0;
  return static_cast<int>(fminf(fmaxf(x, 0.0f), 255.0f));
}

struct Args {
  const float* X;            // (N, F) row-major
  int N, F;
  const int4* rec;           // (S * M) records
  const uint32_t* masks;     // (K, 8) words
  const int* mask_start;     // (S + 1) first mask of each slot
  const float* leaf;         // (S * M, O), read when O > 1
  int O, S, M;
  int group, n_groups, chunks;
  int mask_cap;              // masks a staged block holds
  int rows;                  // examples per tile
  const int* group_rounds;   // rounds of each group, or null: `rounds`
  int rounds;
  const int* slot_col;       // output column of a slot (< 0: none), or null
  int n_cols;                // output columns
  float* out;                // (N, n_cols, O)
};

template <bool kStaged>
__device__ __forceinline__ int4 load_rec(const int4* p) {
  if constexpr (kStaged) return *p;
  else return __ldg(p);
}

template <bool kStaged>
__device__ __forceinline__ uint32_t load_word(const uint32_t* p) {
  if constexpr (kStaged) return *p;
  else return __ldg(p);
}

template <bool kStaged>
__device__ void run(const Args& a) {
  extern __shared__ int4 smem[];
  // chunk-major block order: the blocks in flight together cover the same
  // examples for every group, so the sectors of an output row fill in L2
  const int g = blockIdx.x % a.n_groups;
  const int c = blockIdx.x / a.n_groups;
  const int s0 = g * a.group;
  const int k = min(a.group, a.S - s0);
  const int rounds = a.group_rounds ? __ldg(a.group_rounds + g) : a.rounds;
  const int m0 = __ldg(a.mask_start + s0);

  // staged trees lie (M + 1) records apart, so the roots (and the nodes
  // at equal offsets) of a group's trees fall in different 16-byte bank
  // slots: a quarter warp reading 8 trees' roots is one wavefront, not 8
  const int stride = kStaged ? a.M + 1 : a.M;
  const int4* grec = a.rec + static_cast<long long>(s0) * a.M;
  const int4* rec = grec;
  const uint32_t* words = a.masks + static_cast<long long>(m0) * kMaskWords;
  if constexpr (kStaged) {
    int4* srec = smem;
    uint4* smask = reinterpret_cast<uint4*>(smem + a.group * stride);
    for (int j = 0; j < k; ++j)
      for (int i = threadIdx.x; i < a.M; i += blockDim.x)
        srec[j * stride + i] = __ldg(grec + static_cast<long long>(j) * a.M + i);
    const int nm = (__ldg(a.mask_start + s0 + k) - m0) * 2;
    const uint4* src = reinterpret_cast<const uint4*>(a.masks) + 2LL * m0;
    for (int i = threadIdx.x; i < nm; i += blockDim.x) smask[i] = __ldg(src + i);
    rec = srec;
    words = reinterpret_cast<const uint32_t*>(smask);
    __syncthreads();
  }

  const int n_tiles = (a.N + a.rows - 1) / a.rows;
  const int de = blockDim.x / k, dj = blockDim.x - de * k;
  for (int tile = c; tile < n_tiles; tile += a.chunks) {
    const long long n0 = static_cast<long long>(tile) * a.rows;
    const int rows = static_cast<int>(min(static_cast<long long>(a.rows),
                                          a.N - n0));
    const float* xt = a.X + n0 * a.F;

    // pairs p = e * k + j, trees fastest (whole output sectors); a thread
    // steps by blockDim.x pairs without dividing
    int e = threadIdx.x / k, j = threadIdx.x - (threadIdx.x / k) * k;
    for (; e < rows; e += de, j += dj, e += (j >= k), j -= (j >= k) ? k : 0) {
      const int4* trec = rec + j * stride;
      const float* x = xt + static_cast<long long>(e) * a.F;
      int node = 0;
      for (int r = 0; r < rounds; ++r) {
        const int4 d = load_rec<kStaged>(trec + node);
        if (d.z < 0) break;               // at a leaf: the reference self-loops
        const bool cat = d.x < 0;
        const float v = __ldg(x + (cat ? ~d.x : d.x));
        int go;
        if (cat) {
          const int code = cat_code(v);
          const uint32_t w = load_word<kStaged>(
              words + static_cast<long long>(d.y - m0) * kMaskWords +
              (code >> 5));
          go = static_cast<int>((w >> (code & 31)) & 1u);
        } else {
          go = v >= __int_as_float(d.y) ? 1 : 0;
        }
        node = d.z + go;
      }
      const int4 d = load_rec<kStaged>(trec + node);
      const int slot = s0 + j;
      const int col = a.slot_col ? __ldg(a.slot_col + slot) : slot;
      if (col < 0) continue;              // a padding slot
      float* dst = a.out + ((n0 + e) * a.n_cols + col) * a.O;
      if (a.O == 1) {
        dst[0] = __int_as_float(d.w);
      } else {
        const float* src = a.leaf + static_cast<long long>(d.w) * a.O;
        for (int o = 0; o < a.O; ++o) dst[o] = __ldg(src + o);
      }
    }
  }
}

// Launches `kernel` for `a` with `smem` dynamic shared bytes on `stream`
// and returns cudaGetLastError(). `*opted` records that the kernel may take
// shared memory past 48 KB, up to the block limit (set once per kernel).
inline int launch(void (*kernel)(Args), const Args& a, int smem,
                  cudaStream_t stream, bool* opted) {
  if (smem > 48 * 1024 && !*opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    *opted = true;
  }
  kernel<<<a.n_groups * a.chunks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace forest_traverse
