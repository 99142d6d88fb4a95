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
// A GPU has both, so this is three launches:
//   1. prep:         the exact 64-bit fixed-point preparation of
//                    hist_accumulate.cuh (shared with histogram.cu): the
//                    active rows sorted by slot, their stats in fixed point.
//   2. split_kernel: one block (or a cluster of up to 8) per (slot chunk,
//                    up to 4 columns), as plan.fused_plan lays them out. For
//                    each stat group (the count and up to 15 other stats;
//                    "gh" and "moment" read stats 0, 1 and the count, so
//                    one group) it adds the chunk's rows into int64 cells in
//                    shared memory; then a team of 256 threads (one per bin)
//                    per (slot, column) reads its cells (through distributed
//                    shared memory in a cluster), takes the exact int64
//                    prefix scan over the bins, and scores in float32 from
//                    the exact sums. "class" carries its running entropy
//                    sums per (slot, column, bin) from group to group in
//                    shared memory, classes in order, so any S sums in the
//                    same order. After the last group the team masks and
//                    takes the argmax over bins.
//   3. reduce:       one thread per slot folds the columns in order.
// No global int64 histogram is written, zeroed or reread.
//
// Determinism. Every sum is exact and independent of order
// (hist_accumulate.cuh): two launches on the same inputs give the same
// bits, duplicate columns tie exactly, and near-ties do not flip from run
// to run.
//
// What bounds it on an H100: the bytes it must read (codes N * kf, stats
// N * S * 4, slot N * 4; 4.3 MB at N = 90,000, kf = 28, S = 4, about 1.3 us
// at 3.35 TB/s) are small. What bounds this version: the shared atomics
// (two per non-zero value), the scan's two block barriers per stat, each
// block's short serial phases at wide frontiers, the codes gathered through
// the row index, the prep's barriers, and, for "class", one logf per
// (slot, column, bin, class).

#include "hist_accumulate.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kGH = 0, kClass = 1, kMoment = 2;

__device__ __forceinline__ float gh_score(float g, float h, float l2) {
  return 0.5f * (g * g) / ((h + l2) + 1e-12f);
}

__device__ __forceinline__ float moment_score(float sy, float n) {
  return (sy * sy) / fmaxf(n, 1e-12f);
}

// One class's term p log p of the entropy sum, p = x / max(n, 1e-12).
__device__ __forceinline__ float class_term(float x, float n) {
  const float p = x / fmaxf(n, 1e-12f);
  return __fmul_rn(p, logf(fmaxf(p, 1e-12f)));
}

// a ranks before b: NaN first, then larger, then lower index.
__device__ __forceinline__ bool ranks_before(float ga, int ia, float gb,
                                             int ib) {
  const bool na = isnan(ga), nb = isnan(gb);
  if (na != nb) return na;
  if (!na && ga != gb) return ga > gb;
  return ia < ib;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
split_kernel(const uint8_t* __restrict__ codes, Prep p, int N, int kf, int S,
             int W, int n_bins, int group, int n_groups, int columns,
             int n_colgroups, int slots, int C, int kind, float l2,
             float min_examples, int n_log2, float* __restrict__ col_gain,
             int* __restrict__ col_bin) {
  // [slot][column][256][gs] int64 cells; for "class" then the running sums
  // acc_l, acc_r [slot][column][256] and acc_p [slot][column] in float32
  extern __shared__ unsigned long long sh[];
  __shared__ long long warp_sum[kThreads / 32];
  __shared__ float best_g[kThreads / 32];
  __shared__ int best_i[kThreads / 32];
  __shared__ double inv[kMaxGroup];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C == 1 ? 0 : (int)cluster.block_rank();
  const int f0 = (int)((blockIdx.x / C) % n_colgroups) * columns;
  const int c = (int)((blockIdx.x / C) / n_colgroups);
  const int cg_ = min(columns, kf - f0);
  const int n0 = c * slots, n1 = min(W, n0 + slots), wc = n1 - n0;
  const long long r0 = p.offsets[n0], r1 = p.offsets[n1];
  // this block scores the unit's (slot, column) items rank, rank + C, ...:
  // one team of 256 threads (one per bin) an item
  const int teams = blockDim.x / kBins, team = threadIdx.x / kBins;
  const int b = threadIdx.x % kBins, warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31, team_warp0 = team * (kBins / 32);
  const int items = wc * cg_;
  const int mine = items > rank ? (items - rank + C - 1) / C : 0;
  const int iters = (mine + teams - 1) / teams;
  if (r0 == r1) {   // no row in the chunk: nothing is scoreable
    for (int k = threadIdx.x; k < mine; k += blockDim.x) {
      const int item = rank + C * k;
      const long long at = (long long)(n0 + item / cg_) * kf + f0 + item % cg_;
      col_gain[at] = kNegInf;
      col_bin[at] = 0;
    }
    return;
  }
  float* acc_l = reinterpret_cast<float*>(
      sh + (long long)slots * columns * kBins * (group + 1));
  float* acc_r = acc_l + slots * columns * kBins;
  float* acc_p = acc_r + slots * columns * kBins;
  const int ng = kind == kClass ? n_groups : 1;
  const long long len = r1 - r0;

  for (int g = 0; g < ng; ++g) {
    const int s0 = g * group, gs = min(group, S - 1 - s0) + 1;  // + count
    if (threadIdx.x < gs) {
      const int s = threadIdx.x == gs - 1 ? S - 1 : s0 + threadIdx.x;
      inv[threadIdx.x] = 1.0 / stat_scale(p.amax[s], n_log2);
    }
    zero_shared(sh, items * kBins * gs);
    __syncthreads();
    add_rows<G>(sh, codes, kf, f0, cg_, p.fx, p.node_sorted, p.perm,
             r0 + len * rank / C, r0 + len * (rank + 1) / C, n0, S, s0, gs,
             true, n_bins);
    if (C > 1) cluster.sync(); else __syncthreads();

    for (int it = 0; it < iters; ++it) {
      const int k = it * teams + team;
      const bool valid = k < mine;
      const int w = rank + C * k;          // item: slot * cg_ + column
      float Ln = 0.0f, Rn = 0.0f, Pn = 0.0f;
      float L0 = 0.0f, R0 = 0.0f, P0 = 0.0f, L1 = 0.0f, R1 = 0.0f, P1 = 0.0f;
      float sl = 0.0f, sr = 0.0f, sp = 0.0f;
      if (kind == kClass && g > 0 && valid) {
        sl = acc_l[w * kBins + b];
        sr = acc_r[w * kBins + b];
        sp = acc_p[w];
      }
      // the count first, then the group's stats in order
      for (int q = 0; q < gs; ++q) {
        const int j = q == 0 ? gs - 1 : q - 1;
        long long x = valid ? cluster_cell(cluster, sh,
                                           ((long long)w * kBins + b) * gs + j, C)
                            : 0;
        for (int off = 1; off < 32; off <<= 1) {
          const long long y = __shfl_up_sync(kFull, x, off);
          if (lane >= off) x += y;
        }
        if (lane == 31) warp_sum[warp] = x;
        __syncthreads();
        long long before = 0, total = 0;
        for (int m = 0; m < kBins / 32; ++m) {
          const long long t = warp_sum[team_warp0 + m];
          if (team_warp0 + m < warp) before += t;
          total += t;
        }
        __syncthreads();
        const long long left = x + before;
        const float L = __double2float_rn((double)left * inv[j]);
        const float R = __double2float_rn((double)(total - left) * inv[j]);
        const float P = __double2float_rn((double)total * inv[j]);
        if (q == 0) {
          Ln = L, Rn = R, Pn = P;
        } else if (kind == kClass) {
          sl = __fadd_rn(sl, class_term(L, Ln));
          sr = __fadd_rn(sr, class_term(R, Rn));
          sp = __fadd_rn(sp, class_term(P, Pn));
        } else if (j == 0) {
          L0 = L, R0 = R, P0 = P;
        } else if (j == 1) {
          L1 = L, R1 = R, P1 = P;
        }
      }
      if (g + 1 < ng) {          // "class": carry the sums to the next group
        if (valid) {
          acc_l[w * kBins + b] = sl;
          acc_r[w * kBins + b] = sr;
          if (b == 0) acc_p[w] = sp;
        }
        continue;
      }
      if (gs == 2) L1 = Ln, R1 = Rn, P1 = Pn;   // S = 2: stat 1 is the count
      float gain;
      if (kind == kGH)
        gain = (gh_score(L0, L1, l2) + gh_score(R0, R1, l2)) -
               gh_score(P0, P1, l2);
      else if (kind == kMoment)
        gain = (moment_score(L0, Ln) + moment_score(R0, Rn)) -
               moment_score(P0, Pn);
      else   // score = -n * entropy, each product and sum rounded alone
        gain = __fsub_rn(__fadd_rn(__fmul_rn(-Ln, -sl), __fmul_rn(-Rn, -sr)),
                         __fmul_rn(-Pn, -sp));
      const bool ok = Ln >= min_examples && Rn >= min_examples && b < n_bins - 1;
      if (!ok) gain = kNegInf;
      int gi = b;
      for (int off = 16; off > 0; off >>= 1) {
        const float og = __shfl_down_sync(kFull, gain, off);
        const int oi = __shfl_down_sync(kFull, gi, off);
        if (ranks_before(og, oi, gain, gi)) gain = og, gi = oi;
      }
      if (lane == 0) best_g[warp] = gain, best_i[warp] = gi;
      __syncthreads();
      if (b == 0 && valid) {
        for (int m = 1; m < kBins / 32; ++m)
          if (ranks_before(best_g[team_warp0 + m], best_i[team_warp0 + m], gain, gi))
            gain = best_g[team_warp0 + m], gi = best_i[team_warp0 + m];
        const long long at = (long long)(n0 + w / cg_) * kf + f0 + w % cg_;
        col_gain[at] = gain;
        col_bin[at] = gi;
      }
      __syncthreads();
    }
    // the others may still read this block's cells; the next group zeroes them
    if (C > 1) cluster.sync(); else __syncthreads();
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

// Kernels launched by fused_split since the library was loaded.
extern "C" long long fused_split_kernel_launches() { return g_kernel_launches; }

// Scratch bytes the caller provides: the prep's (prep_layout).
extern "C" long long fused_split_scratch_bytes(int N, int S, int W) {
  return prep_layout(N, S, W, nullptr, nullptr);
}

// Launches on `stream` and returns the first CUDA error (0 on success). The
// caller has checked shapes, types and contiguity, S >= 2, kf >= 1, W >= 1,
// 1 <= n_bins <= 256, that the stats are finite, and passes the plan of
// plan.fused_plan(N, kf, S, W, kind) (group, n_groups, columns,
// n_colgroups, slots, cluster, smem, blocks); rows whose slot is outside
// [0, W) add nothing. `scratch` holds fused_split_scratch_bytes(N, S, W)
// bytes and col_gain /
// col_bin hold W * kf values.
extern "C" int fused_split(const uint8_t* codes, const float* stats,
                           const int* slot_of, int N, int kf, int S, int W,
                           int n_bins, int kind, float l2, float min_examples,
                           int group, int n_groups, int columns,
                           int n_colgroups, int slots, int cluster, int smem,
                           int blocks, void* scratch,
                           float* col_gain, int* col_bin, float* gain,
                           int* column, int* split_bin, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Prep p;
  prep_layout(N, S, W, static_cast<char*>(scratch), &p);
  const int n_log2 = rows_log2(N);  // N < 2^n_log2
  cudaError_t err = launch_prep(stats, slot_of, N, S, W, n_log2, p, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // rows' stats in registers: 4 when a group and the count fit, else 16
  err = launch_clusters(
      group + 1 <= 4 ? split_kernel<4> : split_kernel<kMaxGroup>, blocks,
      cluster, smem, st, codes, p, N, kf, S, W, n_bins, group, n_groups,
      columns, n_colgroups, slots, cluster, kind, l2, min_examples, n_log2,
      col_gain, col_bin);
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<(W + 127) / 128, 128, 0, st>>>(col_gain, col_bin, kf, W,
                                                 gain, column, split_bin);
  ++g_kernel_launches;
  return static_cast<int>(cudaGetLastError());
}
