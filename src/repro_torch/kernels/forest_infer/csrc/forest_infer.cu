// Forest traversal over the depth-packed layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel forest_predict_pallas_tiled
// (src/repro/kernels/forest_infer/forest_infer.py:192, kernel
// _infer_tiled_kernel :131). It computes the same function: every example
// walks every tree of a depth-packed block (core/tree.py pack_by_depth) for
// at most block_depth[b] rounds, node = left_child + go while
// left_child >= 0, where a numerical node goes right when x >= threshold
// and a node with a non-empty 256-bit category mask goes right when the
// code's bit is set. It also serves sparse-oblique nodes, which the TPU
// kernel refuses (the reference serves those forests on the host): such a
// node goes right when its projection, summed as traverse.cuh says, is
// >= threshold. The output is the final node's leaf value, (N, S, O)
// float32 in packed slot order, or, given slot_col (the tree of each slot,
// -1 for padding), (N, T, O) in tree order, so the caller needs no
// separate take over the output.
//
// Design. The TPU kernel turns every gather into a one-hot MXU matmul and
// carries mask words as 16-bit halves through float32, because the TPU has
// no vector gather. Here a thread walks one (example, tree) pair over
// 16-byte node records (layout.py; the round is in traverse.cuh, shared
// with the single-tree kernel). A block takes one packed block of TB trees
// and stages its records and masks in shared memory once (the default
// GBT's 8 trees x 128 nodes are 16 KB, its masks at most another 16 KB),
// then loops over the example tiles of its chunk, reading X through L1
// (a tile of X staged in shared memory did no better on the card). The
// grid is one-dimensional, (chunks x B) blocks, one wave sized by the plan
// (plan.py) to the 132 SMs, so B is bounded by the grid's 2^31 - 1 blocks
// and not by a y axis. Blocks whose
// tables would leave fewer than four blocks an SM (B2's 8 x 4,096-node
// Random Forest blocks, 512 KB) take the record-global variant: the same
// records read with 16-byte __ldg through L1 / L2.
//
// What bounds it on an H100: latency, then the output. A round is a chain
// of dependent shared-memory loads (record, x, maybe a mask word); the
// bytes that must move are X, the tables once and N x T x O x 4 B of
// output (78.6 MB at N = 65,536 for the default GBT: 0.023 ms at
// 3.35 TB/s). Pairs are numbered trees fastest, so a warp's stores cover
// whole 32-byte sectors of packed rows; in tree order a block's TB trees
// scatter over a row, and blocks are ordered chunk-major so the blocks in
// flight together fill each row's sectors in L2.
//
// Left for a later change: summing the GBT's trees on the card, so that
// only (N, out_dim) leaves the device (it changes the bits of the served
// answer against the host's numpy sum).

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse.cuh"

namespace {

template <bool kStaged, bool kOblique>
__global__ void __launch_bounds__(forest_traverse::kThreads)
forest_infer_tiled_kernel(forest_traverse::Args a) {
  forest_traverse::run<kStaged, kOblique>(a);
}

// [staged][oblique]: the oblique branch only where P > 0
void (*const kKernels[2][2])(forest_traverse::Args) = {
    {forest_infer_tiled_kernel<false, false>,
     forest_infer_tiled_kernel<false, true>},
    {forest_infer_tiled_kernel<true, false>,
     forest_infer_tiled_kernel<true, true>}};
bool opted[2][2] = {};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller (layout.py, plan.py) has built and validated the records, masks,
// mask_start, oblique pairs and obl_start, checked X, and planned the grid
// and shared bytes. N > 0.
extern "C" int forest_infer_tiled(
    const float* X, int N, int F, const void* rec, const void* masks,
    const int* mask_start, const void* obl, const int* obl_start, int P,
    const float* leaf, const int* block_depth, const int* slot_col, int S,
    int M, int O, int n_cols, int staged, int group, int n_groups,
    int mask_cap, int rows, int chunks, int smem, float* out, void* stream) {
  forest_traverse::Args a{};
  a.X = X; a.N = N; a.F = F;
  a.rec = static_cast<const int4*>(rec);
  a.masks = static_cast<const uint32_t*>(masks);
  a.mask_start = mask_start;
  a.obl = static_cast<const int2*>(obl);
  a.obl_start = obl_start;
  a.P = P;
  a.leaf = leaf; a.O = O; a.S = S; a.M = M;
  a.group = group; a.n_groups = n_groups; a.chunks = chunks;
  a.mask_cap = mask_cap; a.rows = rows;
  a.group_rounds = block_depth; a.rounds = 0;
  a.slot_col = slot_col; a.n_cols = n_cols; a.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int i = staged ? 1 : 0, j = P > 0 ? 1 : 0;
  return forest_traverse::launch(kKernels[i][j], a, smem, s, &opted[i][j]);
}
