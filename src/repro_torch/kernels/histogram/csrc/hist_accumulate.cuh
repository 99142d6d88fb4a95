// Exact histogram accumulation for Hopper (sm_90a), shared by the
// split-search kernel (fused_split.cu) and the histogram kernel
// (histogram.cu).
//
// For rows r with node_of[r] in [0, n_nodes) and codes[r, f] < n_bins, the
// kernels add stats[r, :] into the cell (node_of[r], f, codes[r, f]) of an
// int64 histogram. Two launches build it:
//   1. prep (cooperative: one launch, grid-wide barriers between phases):
//        a. zero the per-stat maxima and the per-node row counts;
//        b. count the active rows of each node (warp-aggregated atomics)
//           and take each stat's max |v| (shared, then global atomicMax on
//           float bits);
//        c. one block: an exclusive scan of the counts into per-node row
//           offsets, and each stat's power-of-two fixed-point scale;
//        d. scatter the active rows into node order: each row's node id,
//           its original index, and its stats converted once to int64
//           fixed point (N x S x 8 bytes).
//   2. accumulate (hist_kernel, split_kernel): one block per unit of
//        (chunk of consecutive nodes, up to 4 columns, stat group), or a
//        cluster of 2-8 blocks that split the unit's rows; plan.py lays the
//        units out. A block reads only its chunk's rows, each row's node,
//        index and stats once for its columns, and the codes through the
//        index. It adds them into an int64 (slots, columns, 256, group)
//        histogram in shared memory (add_rows), and in a cluster adds the
//        blocks' histograms through distributed shared memory. The unit's
//        cells belong to it alone, so the block writes them itself: no
//        global int64 histogram, no memset and no global atomics.
// The rows are read once per (column group, stat group), not once per
// (column, node chunk) as before.
//
// Atomics. sm_90 has no native 64-bit add on shared memory (a shared
// atomicAdd on unsigned long long compiles to a compare-and-swap loop), so
// add_exact adds each value as two native 32-bit atomics with the carry
// carried by hand, and skips zeros (most of a one-hot class row). Lanes of
// a warp whose rows share a cell (__match_any_sync) first add their values
// in registers in log2(group) shuffle rounds, so a bin that draws every
// row takes one shared atomic per warp instead of 32.
//
// Determinism. Float atomics add in an order that changes from run to run.
// Integer addition is associative, so every sum here is exact and
// independent of order (the scatter's order within a node varies): two
// launches on the same inputs give the same bits, and the count channel is
// exact. Stat s is scaled by 2^stat_shift = 2^(62 - e_s - ceil(log2(N +
// 1))), where max |v_s| < 2^e_s, so no sum of N rows can overflow int64 and
// each value keeps ~45 bits below the largest (float32 accumulation keeps
// 24). The stats must be finite.
//
// Limits: any S (groups of <= 16 stats), any node count below 2^31 (chunks
// on grid x), N below 2^31. Shared memory: a (slot, column) of a group
// takes 256 * group * 8 bytes (8 KB at S = 4, at most 32 KB); a unit takes
// up to 64 KB (plan.SMEM_BUDGET), so that three blocks share an SM. What is
// left: the codes gathered through the row index (one sector per row and
// column group), the int64 stats reread per column group, and the prep's
// three grid-wide barriers.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kBins = 256;
constexpr int kThreads = 512;       // threads of an accumulate block
constexpr int kMaxGroup = 16;       // stats per group (plan.MAX_GROUP)
constexpr int kPrepThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// Kernels this library has launched (prep, accumulate and any other), for
// the wrapper's launches-per-call count; host-side, one per launch call.
long long g_kernel_launches = 0;

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

// The prep launch's scratch: the active rows in node order, and what the
// accumulate blocks need to find their rows and scales.
struct Prep {
  double* scale;           // [S] 2^stat_shift
  long long* fx;           // [N][S] fixed-point stats, node order
  unsigned* amax;          // [S] max |v| bits over active rows
  int* counts;             // [n + 1] active rows per node
  int* offsets;            // [n + 1] first row of each node; [n] = total
  int* cursor;             // [n] scatter cursors
  int* node_sorted;        // [N] node of each row, node order
  int* perm;               // [N] original row of each row, node order
};

// Bytes of a Prep for N rows, S stats and n nodes; with `base`, also points
// `p` into it.
inline long long prep_layout(long long N, int S, long long n,
                             char* base, Prep* p) {
  long long at = 0;
  auto take = [&](long long bytes) {
    char* ptr = base ? base + at : nullptr;
    at += (bytes + 15) / 16 * 16;
    return ptr;
  };
  char* scale = take(8ll * S);
  char* fx = take(8ll * N * S);
  char* amax = take(4ll * S);
  char* counts = take(4ll * (n + 1));
  char* offsets = take(4ll * (n + 1));
  char* cursor = take(4ll * n);
  char* node_sorted = take(4ll * N);
  char* perm = take(4ll * N);
  if (p) {
    p->scale = reinterpret_cast<double*>(scale);
    p->fx = reinterpret_cast<long long*>(fx);
    p->amax = reinterpret_cast<unsigned*>(amax);
    p->counts = reinterpret_cast<int*>(counts);
    p->offsets = reinterpret_cast<int*>(offsets);
    p->cursor = reinterpret_cast<int*>(cursor);
    p->node_sorted = reinterpret_cast<int*>(node_sorted);
    p->perm = reinterpret_cast<int*>(perm);
  }
  return at;
}

// One block: offsets = exclusive scan of counts[0, n), offsets[n] = total,
// cursor = offsets[0, n).
__device__ void block_exclusive_scan(const int* counts, int* offsets,
                                     int* cursor, int n) {
  __shared__ int part[kPrepThreads];
  const int T = blockDim.x, t = threadIdx.x;
  const long long per = ((long long)n + T - 1) / T;
  const long long a = min((long long)n, t * per), b = min((long long)n, a + per);
  int sum = 0;
  for (long long i = a; i < b; ++i) sum += counts[i];
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {
    const int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - sum;
  for (long long i = a; i < b; ++i) {
    offsets[i] = run;
    cursor[i] = run;
    run += counts[i];
  }
  if (t == T - 1) offsets[n] = part[T - 1];
}

__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const float* __restrict__ stats, const int* __restrict__ node_of,
            int N, int S, int n_nodes, int n_log2, Prep p) {
  extern __shared__ unsigned bmax[];    // [S] the block's max |v| bits
  __shared__ int wpos[kPrepThreads];    // each row's state, then its place
  cg::grid_group grid = cg::this_grid();
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nth = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const long long warp0 = tid - lane;   // each warp walks 32 rows at a time

  for (long long i = tid; i < S; i += nth) p.amax[i] = 0u;
  for (long long i = tid; i <= n_nodes; i += nth) p.counts[i] = 0;
  for (int s = threadIdx.x; s < S; s += blockDim.x) bmax[s] = 0u;
  grid.sync();

  // the counts, and each stat's max |v| (per block in shared memory, then
  // once per block into amax): lanes take consecutive (row, stat) pairs of
  // the warp's 32 rows, so that the reads are contiguous for any S
  for (long long r0 = warp0; r0 < N; r0 += nth) {
    const long long r = r0 + lane;
    const int node = r < N ? node_of[r] : -1;
    const bool on = (unsigned)node < (unsigned)n_nodes;
    const unsigned peers = __match_any_sync(kFull, on ? node : -1 - lane);
    if (on && lane == __ffs(peers) - 1)
      atomicAdd(p.counts + node, __popc(peers));
    wpos[threadIdx.x] = on;
    __syncwarp();
    const int rows = (int)min(32ll, N - r0);
    for (int k = lane; k < rows * S; k += 32) {
      const int q = k / S, s = k - q * S;
      if (wpos[threadIdx.x - lane + q])
        atomicMax(bmax + s, __float_as_uint(fabsf(stats[(r0 + q) * S + s])));
    }
    __syncwarp();
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    if (bmax[s]) atomicMax(p.amax + s, bmax[s]);
  grid.sync();

  if (blockIdx.x == 0) {
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      p.scale[s] = stat_scale(p.amax[s], n_log2);
    block_exclusive_scan(p.counts, p.offsets, p.cursor, n_nodes);
  }
  grid.sync();

  for (long long r0 = warp0; r0 < N; r0 += nth) {
    const long long r = r0 + lane;
    const int node = r < N ? node_of[r] : -1;
    const bool on = (unsigned)node < (unsigned)n_nodes;
    const unsigned peers = __match_any_sync(kFull, on ? node : -1 - lane);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (on && lane == leader) base = atomicAdd(p.cursor + node, __popc(peers));
    base = __shfl_sync(kFull, base, leader);
    const int pos = base + __popc(peers & ((1u << lane) - 1u));
    if (on) {
      p.node_sorted[pos] = node;
      p.perm[pos] = (int)r;
    }
    // the warp's rows' stats in fixed point: lanes take consecutive (row,
    // stat) pairs, so that reads and writes are contiguous for any S
    wpos[threadIdx.x] = on ? pos : -1;
    __syncwarp();
    const int rows = (int)min(32ll, N - r0);
    for (int k = lane; k < rows * S; k += 32) {
      const int q = k / S, s = k - q * S;
      const int at = wpos[threadIdx.x - lane + q];
      if (at >= 0)
        p.fx[(long long)at * S + s] =
            __double2ll_rn((double)stats[(r0 + q) * S + s] * p.scale[s]);
    }
    __syncwarp();
  }
}

// Launches prep on `st` with as many blocks as the card holds at once (a
// cooperative launch needs them all resident). Returns the first error.
inline cudaError_t launch_prep(const float* stats, const int* node_of,
                               int N, int S, int n_nodes, int n_log2, Prep p,
                               cudaStream_t st) {
  static int sms[64];   // per device, filled on first use
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(sms + dev, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int smem = 4 * S;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(prep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prep_kernel,
                                                      kPrepThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long want = max(1ll, ((long long)N + kPrepThreads - 1) / kPrepThreads);
  const int blocks = (int)min((long long)sms[dev] * per_sm, want);
  void* args[] = {&stats, &node_of, &N, &S, &n_nodes, &n_log2, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(prep_kernel),
                                    blocks, kPrepThreads, args, smem, st);
  if (err != cudaSuccess) return err;
  ++g_kernel_launches;
  return cudaGetLastError();
}

// Adds one value to a shared int64 cell exactly with two native 32-bit
// atomics (sm_90 emulates a shared 64-bit atomicAdd with a compare-and-swap
// loop): the low word's carry out goes into the high word. The carries
// number floor(sum of low words / 2^32) in any order, so the cell ends
// with the exact sum mod 2^64, which is the sum, as no sum overflows int64.
__device__ __forceinline__ void add_exact(unsigned long long* cell,
                                          long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(cell);   // little-endian words
  const unsigned lo = static_cast<unsigned>(v);
  const unsigned hi = static_cast<unsigned>(static_cast<unsigned long long>(v) >> 32);
  const unsigned old = atomicAdd(w, lo);
  const unsigned up = hi + (old + lo < old ? 1u : 0u);
  if (up) atomicAdd(w + 1, up);
}

// Adds the node-ordered rows [a, b) into the shared histogram
// sh[slot][column][256][gs] of the unit whose first node is n0 and whose
// columns are f0 .. f0 + cg - 1 of the row-major codes (N, F). Local stat j
// is fx column s0 + j, except that with count_last the last one
// (j = gs - 1) is column S - 1, the count; gs <= G, the registers a row's
// stats take. A row's node, original index
// and stats are read once for its cg columns. Per column, lanes whose rows
// share a cell add their values in registers first, and the lowest of them
// adds the sum.
template <int G>
__device__ __forceinline__ void add_rows(
    unsigned long long* sh, const uint8_t* __restrict__ codes, int F, int f0,
    int cg, const long long* __restrict__ fx,
    const int* __restrict__ node_sorted, const int* __restrict__ perm,
    long long a, long long b, int n0, int S, int s0, int gs, bool count_last,
    int n_bins) {
  const int lane = threadIdx.x & 31;
  for (long long i0 = a + (threadIdx.x - lane); i0 < b; i0 += blockDim.x) {
    const long long i = i0 + lane;
    const bool in = i < b;
    const int slot = in ? node_sorted[i] - n0 : 0;
    const uint8_t* row = codes + (in ? (long long)perm[i] * F + f0 : 0);
    long long v[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      v[j] = 0;
      if (in && j < gs)
        v[j] = fx[i * S + (count_last && j == gs - 1 ? S - 1 : s0 + j)];
    }
    for (int c = 0; c < cg; ++c) {
      const int code = in ? row[c] : 0;
      const bool ok = in && code < n_bins;
      const int key = ok ? (slot * cg + c) * kBins + code : -1 - lane;
      const unsigned peers = __match_any_sync(kFull, key);
      // tree sum over each group of peers: the lowest lane ends with the sum
      const bool leader = (peers & ((1u << lane) - 1u)) == 0u;
      unsigned higher = peers & ~((2u << lane) - 1u);
      int rel = __popc(peers & ((1u << lane) - 1u));
      long long t[G];
#pragma unroll
      for (int j = 0; j < G; ++j) t[j] = v[j];
      while (__any_sync(kFull, higher != 0u)) {
        const int next = higher ? __ffs(higher) - 1 : lane;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < gs) {   // gs is the same in every lane
            const long long u = __shfl_sync(kFull, t[j], next);
            if (next != lane) t[j] += u;
          }
        }
        higher &= __ballot_sync(kFull, (rel & 1) == 0);
        rel >>= 1;
      }
      if (ok && leader) {
        unsigned long long* cell = sh + key * gs;
#pragma unroll
        for (int j = 0; j < G; ++j)
          if (j < gs && t[j] != 0) add_exact(cell + j, t[j]);
      }
    }
  }
}

// Zeroes sh[0, n) (n even), 16 bytes a store.
__device__ __forceinline__ void zero_shared(unsigned long long* sh, int n) {
  ulonglong2* v = reinterpret_cast<ulonglong2*>(sh);
  for (int i = threadIdx.x; i < n / 2; i += blockDim.x) v[i] = make_ulonglong2(0, 0);
}

// Launches `kernel` on `st` as clusters of `cluster` blocks along x.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int blocks, int cluster,
                            int smem, cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;   // a cluster launch only where needed
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  ++g_kernel_launches;
  return cudaGetLastError();
}

// The sum of a shared cell over the blocks of the cluster.
__device__ __forceinline__ long long cluster_cell(cg::cluster_group& cluster,
                                                  unsigned long long* sh,
                                                  long long cell, int C) {
  if (C == 1) return static_cast<long long>(sh[cell]);
  unsigned long long v = 0;
  for (int q = 0; q < C; ++q) v += cluster.map_shared_rank(sh, q)[cell];
  return static_cast<long long>(v);
}

}  // namespace
