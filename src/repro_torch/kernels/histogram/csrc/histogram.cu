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
// because a TPU has no scatter. A GPU has one, so this is two launches on
// the exact accumulation of hist_accumulate.cuh:
//   1. prep:        the active rows sorted by node, their stats in 64-bit
//                   fixed point;
//   2. hist_kernel: one block (or a cluster of up to 8) per (node chunk,
//                   up to 4 columns, group of <= 16 stats), as
//                   plan.histogram_plan lays them out. It adds its chunk's
//                   rows into int64 cells in shared memory, adds a
//                   cluster's blocks through distributed shared memory, and
//                   writes the float32 output of its cells itself: the
//                   correctly rounded float32 of each exact sum
//                   (__ll2float_rn, then an exact power-of-two scale in two
//                   normal factors). A chunk with no row writes zeros and
//                   touches no shared memory.
// The sums are exact and order-free, so two launches give the same bits and
// the count channel is exact. Any S (groups) and any node count (chunks on
// grid x) run; the scratch (prep_layout) grows with N * S, not with
// n_nodes * F * 256 * S. The kernel is instantiated for groups of 4 stats
// (40 registers a thread: three blocks of 512 threads share an SM) and of
// 16.
//
// What bounds it on an H100: the bytes it must move (codes N * F, stats
// N * S * 4, node_of N * 4 read once, the float32 output written once:
// 7.8 MB at N = 90,000, F = 28, S = 4, n_nodes = 32, about 2.3 us at
// 3.35 TB/s; 176 MB, 53 us, at the RF's 2,048-node level). What bounds this
// version: the shared atomics (two per non-zero value, N * F * S), each
// block's short serial phases (zero, accumulate, write) at deep levels,
// the codes gathered through the row index, and the prep's barriers.

#include "hist_accumulate.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ codes, Prep p, int N, int F, int S,
            int n_nodes, int n_bins, int group, int n_groups, int columns,
            int n_colgroups, int slots, int C, int n_log2,
            float* __restrict__ out) {
  extern __shared__ unsigned long long sh[];   // [slot][column][256][gs]
  __shared__ float down[kMaxGroup][2];   // 2^-shift in two exact factors
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C == 1 ? 0 : (int)cluster.block_rank();
  long long u = blockIdx.x / C;
  const int g = (int)(u % n_groups);
  u /= n_groups;
  const int f0 = (int)(u % n_colgroups) * columns;
  const int c = (int)(u / n_colgroups);
  const int cg_ = min(columns, F - f0);
  const int n0 = c * slots, n1 = min(n_nodes, n0 + slots), wc = n1 - n0;
  const int s0 = g * group, gs = min(group, S - s0);
  const long long r0 = p.offsets[n0], r1 = p.offsets[n1];
  // this block writes the cells [o0, o1) of the unit's (wc, cg_, n_bins, gs)
  const int total = wc * cg_ * n_bins * gs;
  const int o0 = (int)((long long)total * rank / C);
  const int o1 = (int)((long long)total * (rank + 1) / C);
  float* base = out + ((long long)n0 * F + f0) * n_bins * S + s0;
  const long long node_stride = (long long)F * n_bins * S;
  const bool empty = r0 == r1;   // the same in every block of the cluster
  if (!empty) {
    if (threadIdx.x < gs) {
      const int sh_ = stat_shift(p.amax[s0 + threadIdx.x], n_log2);
      // |sh_| <= 209, so each half's power of two is a normal float
      down[threadIdx.x][0] = __int_as_float((127 - sh_ / 2) << 23);
      down[threadIdx.x][1] = __int_as_float((127 - (sh_ - sh_ / 2)) << 23);
    }
    zero_shared(sh, wc * cg_ * kBins * gs);
    __syncthreads();
    const long long len = r1 - r0;
    add_rows<G>(sh, codes, F, f0, cg_, p.fx, p.node_sorted, p.perm,
             r0 + len * rank / C, r0 + len * (rank + 1) / C, n0, S, s0, gs,
             false, n_bins);
    if (C > 1) cluster.sync(); else __syncthreads();
  }
  // item = w * cg_ + column: its cells lie at item * 256 * gs + e, e = b *
  // gs + j; b = e / gs from a float reciprocal, exact for e < 2^12
  const int per_item = n_bins * gs;
  const float inv_gs = 1.0f / gs;
  for (int item = o0 / per_item; item * per_item < o1; ++item) {
    const int w = item / cg_, col = item - w * cg_;
    float* dst = base + w * node_stride + (long long)col * n_bins * S;
    const long long cell0 = (long long)item * kBins * gs;
    const int e0 = max(o0 - item * per_item, 0);
    const int e1 = min(o1 - item * per_item, per_item);
    for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
      const int b = (int)((e + 0.5f) * inv_gs), j = e - b * gs;
      float v = 0.0f;
      if (!empty)
        v = __fmul_rn(__fmul_rn(__ll2float_rn(cluster_cell(cluster, sh,
                                                           cell0 + e, C)),
                                down[j][0]),
                      down[j][1]);
      dst[b * S + j] = v;
    }
  }
  if (C > 1 && !empty) cluster.sync();   // the others may still read this block
}

}  // namespace

// Kernels launched by histogram since the library was loaded.
extern "C" long long histogram_kernel_launches() { return g_kernel_launches; }

// Scratch bytes the caller provides: the prep's (prep_layout).
extern "C" long long histogram_scratch_bytes(int N, int S, int n_nodes) {
  return prep_layout(N, S, n_nodes, nullptr, nullptr);
}

// Launches on `stream` and returns the first CUDA error (0 on success). The
// caller has checked shapes, types and contiguity, N >= 1, F >= 1, S >= 1,
// n_nodes >= 1, 1 <= n_bins <= 256, that the stats are finite, and passes
// the plan of plan.histogram_plan(N, F, S, n_nodes) (group, n_groups,
// columns, n_colgroups, slots, cluster, smem, blocks); rows whose node is
// outside [0, n_nodes) add nothing. `scratch` holds
// histogram_scratch_bytes(N, S, n_nodes)
// bytes and `out` n_nodes * F * n_bins * S floats.
extern "C" int histogram(const uint8_t* codes, const float* stats,
                         const int* node_of, int N, int F, int S, int n_nodes,
                         int n_bins, int group, int n_groups, int columns,
                         int n_colgroups, int slots, int cluster, int smem,
                         int blocks, void* scratch,
                         float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Prep p;
  prep_layout(N, S, n_nodes, static_cast<char*>(scratch), &p);
  const int n_log2 = rows_log2(N);  // N < 2^n_log2
  cudaError_t err = launch_prep(stats, node_of, N, S, n_nodes, n_log2, p, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // rows' stats in registers: 4 when the groups are that narrow, else 16
  err = launch_clusters(group <= 4 ? hist_kernel<4> : hist_kernel<kMaxGroup>,
                        blocks, cluster, smem, st, codes, p, N, F, S, n_nodes,
                        n_bins, group, n_groups, columns, n_colgroups, slots,
                        cluster, n_log2, out);
  return static_cast<int>(err);
}
