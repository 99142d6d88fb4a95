// The traversal shared by forest_infer.cu (B2, the depth-packed layout) and
// forest_single.cu (B4, the unpacked SoA): a block walks every (example,
// tree) pair of one group of trees over the example tiles of its chunk.
//
// Nodes are 16-byte records (kernels/forest_infer/layout.py): x = the
// column (>= 0), ~column for a categorical node (-2^30 <= x < 0), or
// k - 2^31 for the k-th sparse-oblique node (x < -2^30); y = the
// threshold's bits, or a categorical node's mask index; z = left_child
// (< 0: leaf); w = the leaf value's bits (O == 1) or its row in the leaf
// table. So a round is one 16-byte load, then one float compare, one
// 32-bit mask-word test, or one projection. A numerical node goes right
// when x >= threshold, a categorical one when the bit of the code of x is
// set, an oblique one when its projection >= threshold; leaves self-loop in
// the reference, so the walk stops at the first leaf, which is the same
// function.
//
// An oblique node's projection is the float32 sum over all P of its
// (column, weight) pairs of w * x[column], the padding pairs (weight 0 on
// column 0) included, so a NaN or +-inf in column 0 makes it NaN and sends
// the row left, as the reference's vectorized engine does. Each product is
// rounded before it is added (__fmul_rn / __fadd_rn: nvcc would otherwise
// contract acc + w * x into an FMA), and the adds follow numpy's float32
// pairwise order, the order of the reference's (w * xs).sum(-1): below 8
// pairs in order; up to 128 eight accumulators, combined
// ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the remainder in
// order; past 128 split at n/2 rounded down to a multiple of 8 and add the
// halves' sums (split_sum, an explicit stack). The oblique side table holds
// P pairs per oblique node, slot-ordered, obl_start giving a slot's first
// node; a staged block copies its group's pairs after its masks. The
// oblique branch is compiled only into the kOblique instantiations, which
// the launch picks when P > 0: the projection's registers and split_sum's
// stack frame would otherwise weigh on every axis-aligned walk.
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
// bytes that must move are X, the tables once (an oblique node's 8 P bytes
// of pairs included), and N x T x O floats of output. An oblique round adds
// P gathered loads of x and 2 P flops to the chain. The design keeps the
// chain in shared memory or L1, keeps many warps an SM in flight, and makes
// a warp's stores whole sectors (pairs are numbered trees fastest).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace forest_traverse {

constexpr int kMaskWords = 8;
constexpr int kThreads = 256;       // plan.THREADS
constexpr int kSmemLimit = 232448;  // plan.SMEM_LIMIT
constexpr int kOblBase = -(1 << 30);  // x below: oblique (layout.KIND_LIMIT)
constexpr int kPairwiseBlock = 128;   // numpy's PW_BLOCKSIZE
constexpr int kMaxSplits = 32;        // split_sum's stack (P < 2^30)

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
  const int2* obl;           // (J * P) (column, weight bits) pairs
  const int* obl_start;      // (S + 1) first oblique node of each slot
  int P;                     // pairs per oblique node
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
__device__ __forceinline__ int2 load_pair(const int2* p) {
  if constexpr (kStaged) return *p;
  else return __ldg(p);
}

// w * x[column] of pair i, rounded to float32
template <bool kStaged>
__device__ __forceinline__ float product(const int2* e, const float* x,
                                         int i) {
  const int2 p = load_pair<kStaged>(e + i);
  return __fmul_rn(__int_as_float(p.y), __ldg(x + p.x));
}

// numpy's pairwise sum of n <= 128 products
template <bool kStaged>
__device__ __forceinline__ float block_sum(const int2* e, const float* x,
                                           int n) {
  if (n < 8) {
    float r = -0.0f;
    for (int i = 0; i < n; ++i) r = __fadd_rn(r, product<kStaged>(e, x, i));
    return r;
  }
  float r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = product<kStaged>(e, x, j);
  int i = 8;
  for (const int lim = n - (n & 7); i < lim; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      r[j] = __fadd_rn(r[j], product<kStaged>(e, x, i + j));
  }
  const float lo = __fadd_rn(__fadd_rn(r[0], r[1]), __fadd_rn(r[2], r[3]));
  const float hi = __fadd_rn(__fadd_rn(r[4], r[5]), __fadd_rn(r[6], r[7]));
  float res = __fadd_rn(lo, hi);
  for (; i < n; ++i) res = __fadd_rn(res, product<kStaged>(e, x, i));
  return res;
}

// n > 128: numpy's recursion (left half of n/2 - (n/2) % 8 products, right
// half the rest, their sums added) as a loop over an explicit stack
template <bool kStaged>
__device__ __noinline__ float split_sum(const int2* e, const float* x, int n) {
  struct Frame { int off, n; float left; bool right; };
  Frame st[kMaxSplits];
  int sp = 0;
  st[0] = {0, n, 0.0f, false};
  for (;;) {
    const Frame f = st[sp];
    if (f.n > kPairwiseBlock) {         // descend into the left half
      const int h = f.n / 2 - (f.n / 2) % 8;
      st[++sp] = {f.off, h, 0.0f, false};
      continue;
    }
    float val = block_sum<kStaged>(e + f.off, x, f.n);
    for (;;) {                          // climb
      if (sp == 0) return val;
      Frame& p = st[--sp];
      if (!p.right) {                   // the left half is done: the right
        const int h = p.n / 2 - (p.n / 2) % 8;
        p.left = val;
        p.right = true;
        st[++sp] = {p.off + h, p.n - h, 0.0f, false};
        break;
      }
      val = __fadd_rn(p.left, val);     // both halves done
    }
  }
}

template <bool kStaged>
__device__ __forceinline__ float projection(const int2* e, const float* x,
                                            int n) {
  return n <= kPairwiseBlock ? block_sum<kStaged>(e, x, n)
                             : split_sum<kStaged>(e, x, n);
}

template <bool kStaged, bool kOblique>
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
  const int o0 = __ldg(a.obl_start + s0);

  // staged trees lie (M + 1) records apart, so the roots (and the nodes
  // at equal offsets) of a group's trees fall in different 16-byte bank
  // slots: a quarter warp reading 8 trees' roots is one wavefront, not 8
  const int stride = kStaged ? a.M + 1 : a.M;
  const int4* grec = a.rec + static_cast<long long>(s0) * a.M;
  const int4* rec = grec;
  const uint32_t* words = a.masks + static_cast<long long>(m0) * kMaskWords;
  // the group's oblique pairs: node o0's first, so node k's at (k - o0) * P
  const int2* pairs = a.obl + static_cast<long long>(o0) * a.P;
  if constexpr (kStaged) {
    int4* srec = smem;
    uint4* smask = reinterpret_cast<uint4*>(smem + a.group * stride);
    for (int j = 0; j < k; ++j)
      for (int i = threadIdx.x; i < a.M; i += blockDim.x)
        srec[j * stride + i] = __ldg(grec + static_cast<long long>(j) * a.M + i);
    const int nm = (__ldg(a.mask_start + s0 + k) - m0) * 2;
    const uint4* src = reinterpret_cast<const uint4*>(a.masks) + 2LL * m0;
    for (int i = threadIdx.x; i < nm; i += blockDim.x) smask[i] = __ldg(src + i);
    int2* spair = reinterpret_cast<int2*>(smask + nm);
    const int np = (__ldg(a.obl_start + s0 + k) - o0) * a.P;
    for (int i = threadIdx.x; i < np; i += blockDim.x)
      spair[i] = __ldg(pairs + i);
    rec = srec;
    words = reinterpret_cast<const uint32_t*>(smask);
    pairs = spair;
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
        if constexpr (kOblique) {
          if (d.x < kOblBase) {           // sparse oblique
            const int kn = d.x & 0x3FFFFFFF;
            const float proj = projection<kStaged>(
                pairs + static_cast<long long>(kn - o0) * a.P, x, a.P);
            node = d.z + (proj >= __int_as_float(d.y) ? 1 : 0);
            continue;
          }
        }
        // one load of x for both axis-aligned kinds, before they diverge
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
