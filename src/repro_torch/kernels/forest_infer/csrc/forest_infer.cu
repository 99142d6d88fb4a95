// Forest traversal over the depth-packed layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel forest_predict_pallas_tiled
// (src/repro/kernels/forest_infer/forest_infer.py, kernel
// _infer_tiled_kernel). It computes the same function: every example walks
// every tree of a depth-packed block (core/tree.py pack_by_depth) for at
// most block_depth[b] rounds, node = left_child + go while left_child >= 0,
// where a numerical node goes right when x >= threshold and a node with a
// non-empty 256-bit category mask goes right when the code's bit is set.
// The output is the final node's leaf value, (N, B*TB, O) float32 in packed
// tree order; the caller restores tree order with inv_order.
//
// Design. The TPU kernel turns every gather into a one-hot MXU matmul and
// carries mask words as 16-bit halves through float32, because the TPU has
// no vector gather. A GPU thread gathers directly, so here one thread walks
// one (example, tree) pair and reads the node tables as int32 / float32 /
// uint32 words. The grid is (example tiles, tree blocks); a thread block is
// TB trees x (256 / TB) examples, with the tree index fastest, so a warp
// writes whole output rows of TB * O consecutive floats. A thread stops at
// its leaf (leaves self-loop in the reference, so stopping early is the
// same function).
//
// What bounds it on an H100: memory and launch overhead, not arithmetic.
// The default GBT's node tables are 300 trees x 128 nodes x 48 B = 1.8 MB,
// read through L1 and resident in the 50 MB L2; the output is N x 300 x 4 B
// written once; a round is a few dependent loads and one compare.
//
// Left for a later change: staging a block's tables in shared memory (8
// trees x 128 nodes x 48 B = 48 KB), packing a node's fields into one
// 16-byte record so a round is one load, and fusing the inv_order take and
// the GBT sum into the kernel so only (N, out_dim) leaves the device.
//
// Categorical codes follow numpy's float32 -> int64 cast, which the
// reference CPU engines use: NaN, +-inf and |x| >= 2^63 become INT64_MIN,
// which the clip to [0, 255] makes 0. A plain (long long)x would saturate
// +inf to INT64_MAX (code 255) and map NaN to 0, so the rule is written
// out in cat_code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaskWords = 8;
constexpr int kThreadsPerBlock = 256;

__device__ __forceinline__ int cat_code(float x) {
  if (isnan(x) || x >= 9223372036854775808.0f || x < -9223372036854775808.0f)
    return 0;
  return static_cast<int>(fminf(fmaxf(x, 0.0f), 255.0f));
}

__global__ void forest_infer_tiled_kernel(
    const float* __restrict__ X, int N, int F,
    const int* __restrict__ feature, const float* __restrict__ threshold,
    const uint32_t* __restrict__ cat_mask, const int* __restrict__ left_child,
    const float* __restrict__ leaf_value, const int* __restrict__ block_depth,
    int TB, int M, int O, float* __restrict__ out) {
  const int j = threadIdx.x;  // tree within the block
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (n >= N) return;
  const int b = blockIdx.y;
  const long long slot = static_cast<long long>(b) * TB + j;  // packed tree
  const long long base = slot * M;
  const float* x = X + n * F;
  const int depth = __ldg(block_depth + b);

  int node = 0;
  for (int r = 0; r < depth; ++r) {
    const long long at = base + node;
    const int child = __ldg(left_child + at);
    if (child < 0) break;  // at a leaf: the reference self-loops here
    const float v = x[max(__ldg(feature + at), 0)];
    const uint4* w = reinterpret_cast<const uint4*>(cat_mask + at * kMaskWords);
    const uint4 lo = __ldg(w), hi = __ldg(w + 1);
    const bool is_cat = (lo.x | lo.y | lo.z | lo.w | hi.x | hi.y | hi.z | hi.w) != 0u;
    int go;
    if (is_cat) {
      const int code = cat_code(v);
      const uint32_t word = __ldg(cat_mask + at * kMaskWords + (code >> 5));
      go = static_cast<int>((word >> (code & 31)) & 1u);
    } else {
      go = v >= __ldg(threshold + at) ? 1 : 0;
    }
    node = child + go;
  }

  const float* leaf = leaf_value + (base + node) * O;
  float* dst = out + (n * gridDim.y * TB + slot) * O;
  for (int o = 0; o < O; ++o) dst[o] = __ldg(leaf + o);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller has checked shapes, types, contiguity, 16-byte alignment of
// cat_mask, 1 <= TB <= 256, 1 <= B <= 65535, feature < F on every internal
// node and left_child < M - 1.
extern "C" int forest_infer_tiled(const float* X, int N, int F,
                                  const int* feature, const float* threshold,
                                  const uint32_t* cat_mask,
                                  const int* left_child,
                                  const float* leaf_value,
                                  const int* block_depth, int B, int TB, int M,
                                  int O, float* out, void* stream) {
  if (N == 0) return 0;
  const dim3 block(TB, kThreadsPerBlock / TB);
  const dim3 grid((N + block.y - 1) / block.y, B);
  forest_infer_tiled_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      X, N, F, feature, threshold, cat_mask, left_child, leaf_value,
      block_depth, TB, M, O, out);
  return static_cast<int>(cudaGetLastError());
}
