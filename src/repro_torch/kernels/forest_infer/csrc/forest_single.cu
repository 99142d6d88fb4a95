// Forest traversal over the unpacked SoA, for Hopper (sm_90a).
//
// Replaces the TPU kernel forest_predict_pallas
// (src/repro/kernels/forest_infer/forest_infer.py:94, kernel _infer_kernel
// :52), reached through forest_predict(impl="single"). It computes the
// function of the reference's predict_naive over the unpacked (T, M)
// tables: every example walks every tree for max(1, depth) rounds, depth
// being the forest's global depth; a numerical node goes right when
// x >= threshold, a node with a non-empty 256-bit category mask when the
// bit of cat_code(x) is set, a sparse-oblique node (which the TPU kernel
// refuses) when its projection, summed as traverse.cuh says, is
// >= threshold; leaves self-loop. The output is the final
// node's leaf value, (N, T, O) float32 in tree order.
//
// Design. The TPU kernel selects a node by a one-hot (TN, M) MXU matmul
// per round against one tree's tables, because the TPU has no gather; the
// one-hot capped M at the VMEM budget, and it carried the uint32 mask words
// through float32, which loses the low bits of a word such as 0x80000001
// (ROADMAP C). Here a thread walks one (example, tree) pair over 16-byte
// node records (layout.py; the round is in traverse.cuh, shared with the
// tiled kernel), reading the mask words as they are.
//
// A block takes a group of consecutive trees and loops over the example
// tiles of its chunk; the grid is one-dimensional (chunks x groups), so T
// is bounded by the grid's 2^31 - 1 blocks, not by a 65,535 y axis. The
// output is written coalesced by the block covering several trees of one
// example tile: pairs are numbered trees fastest, and a group has
// ceil(8 / O) trees where the plan allows, so a warp stores whole 32-byte
// sectors of each (N, T, O) row (one tree per block would store O floats
// per row, a quarter sector at O = 2). That was chosen over a transpose
// through shared memory, which would only add a pass: a block holding one
// tree cannot make its row segments longer than O floats however it
// orders them. The group's records and masks are staged in shared memory
// where four such blocks fit an SM (the default GBT's 8 trees x 128 nodes,
// 16 KB); a Random Forest tree of 4,096 nodes (64 KB) is read with 16-byte
// __ldg by blocks of 4 trees instead, which on the H100 beat staging it
// in one-tree blocks (chip_smoke.py's timings, PERF.md).
//
// What bounds it on an H100: latency (a round is a chain of dependent
// loads), then at large N the N x T x O x 4 B of output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse.cuh"

namespace {

template <bool kStaged, bool kOblique>
__global__ void __launch_bounds__(forest_traverse::kThreads)
forest_single_kernel(forest_traverse::Args a) {
  forest_traverse::run<kStaged, kOblique>(a);
}

// [staged][oblique]: the oblique branch only where P > 0
void (*const kKernels[2][2])(forest_traverse::Args) = {
    {forest_single_kernel<false, false>,
     forest_single_kernel<false, true>},
    {forest_single_kernel<true, false>,
     forest_single_kernel<true, true>}};
bool opted[2][2] = {};

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller (layout.py, plan.py) has built and validated the records, masks,
// mask_start, oblique pairs and obl_start, checked X, and planned the grid
// and shared bytes. N > 0, T >= 1, rounds >= 1.
extern "C" int forest_predict_single(
    const float* X, int N, int F, const void* rec, const void* masks,
    const int* mask_start, const void* obl, const int* obl_start, int P,
    const float* leaf, int T, int M, int O, int rounds, int staged,
    int group, int n_groups, int mask_cap, int rows, int chunks, int smem,
    float* out, void* stream) {
  forest_traverse::Args a{};
  a.X = X; a.N = N; a.F = F;
  a.rec = static_cast<const int4*>(rec);
  a.masks = static_cast<const uint32_t*>(masks);
  a.mask_start = mask_start;
  a.obl = static_cast<const int2*>(obl);
  a.obl_start = obl_start;
  a.P = P;
  a.leaf = leaf; a.O = O; a.S = T; a.M = M;
  a.group = group; a.n_groups = n_groups; a.chunks = chunks;
  a.mask_cap = mask_cap; a.rows = rows;
  a.group_rounds = nullptr; a.rounds = rounds;
  a.slot_col = nullptr; a.n_cols = T; a.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int i = staged ? 1 : 0, j = P > 0 ? 1 : 0;
  return forest_traverse::launch(kKernels[i][j], a, smem, s, &opted[i][j]);
}
