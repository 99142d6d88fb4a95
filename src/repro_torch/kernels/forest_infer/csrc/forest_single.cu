// Single-tree-per-block forest traversal over the raw SoA, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel forest_predict_pallas
// (src/repro/kernels/forest_infer/forest_infer.py:94, kernel _infer_kernel
// :52), reached through forest_predict(impl="single"). It computes the
// function of the reference's predict_naive over the unpacked (T, M)
// tables: every example walks every tree for max(1, depth) rounds, depth
// being the forest's global depth; a numerical node goes right when
// x >= threshold, a node with a non-empty 256-bit category mask when the
// bit of cat_code(x) is set; leaves self-loop. The output is the final
// node's leaf value, (N, T, O) float32 in tree order (the SoA is not
// packed, so there is no inv_order).
//
// Design. The TPU kernel selects a node by a one-hot (TN, M) MXU matmul
// per round against one tree's tables, because the TPU has no gather; the
// one-hot capped M at the VMEM budget, and it carried the uint32 mask words
// through float32, which loses the low bits of a word such as 0x80000001
// (ROADMAP C). A GPU thread gathers directly: one thread walks one
// (example, tree) pair and reads the words as they are (traverse.cuh, the
// round shared with the tiled kernel). The grid keeps the TPU grid's idea,
// example tiles x trees: a block is 256 examples of ONE tree, so its warps
// share that tree's node table through L1 and L2.
//
// Layout. Trees are on the grid's slow axis (blockIdx.y, so T <= 65,535,
// which the wrapper checks), example tiles on the fast one, so the blocks
// scheduled together walk the same tree. The output stays (N, T, O), the
// reference's layout: a warp's 32 stores are strided by T * O floats, one
// sector each. A simple kernel that is right comes first; writing a
// (T, N, O) scratch coalesced and transposing it is left for later.
//
// What bounds it on an H100: memory. A Random Forest tree of M = 4,096
// nodes is 4,096 x (4 + 4 + 32 + 4 + 4 O) B, ~213 KB at O = 2; the kernel
// reads it through __ldg from L1/L2. Staging a tree in shared memory (up
// to 227 KB a block) is left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse.cuh"

namespace {

constexpr int kThreadsPerBlock = 256;

__global__ void forest_single_kernel(
    const float* __restrict__ X, int N, int F,
    const int* __restrict__ feature, const float* __restrict__ threshold,
    const uint32_t* __restrict__ cat_mask, const int* __restrict__ left_child,
    const float* __restrict__ leaf_value, int T, int M, int O, int depth,
    float* __restrict__ out) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int t = blockIdx.y;
  const long long base = static_cast<long long>(t) * M;
  const int node = forest_traverse::walk(X + n * F, base, depth, feature,
                                         threshold, cat_mask, left_child);
  const float* leaf = leaf_value + (base + node) * O;
  float* dst = out + (n * T + t) * O;
  for (int o = 0; o < O; ++o) dst[o] = __ldg(leaf + o);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller has checked shapes, types, contiguity, 16-byte alignment of
// cat_mask, 1 <= T <= 65535, O >= 1, depth >= 1, feature < F on every
// internal node and left_child < M - 1.
extern "C" int forest_predict_single(const float* X, int N, int F,
                                     const int* feature,
                                     const float* threshold,
                                     const uint32_t* cat_mask,
                                     const int* left_child,
                                     const float* leaf_value, int T, int M,
                                     int O, int depth, float* out,
                                     void* stream) {
  if (N == 0) return 0;
  const dim3 grid((N + kThreadsPerBlock - 1) / kThreadsPerBlock, T);
  forest_single_kernel<<<grid, kThreadsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      X, N, F, feature, threshold, cat_mask, left_child, leaf_value, T, M, O,
      depth, out);
  return static_cast<int>(cudaGetLastError());
}
