// One tree walk, shared by the traversal kernels: forest_infer.cu (the
// depth-packed layout, B2) and forest_single.cu (the raw SoA, B4).
//
// A numerical node goes right when x >= threshold; a node with a non-empty
// 256-bit category mask goes right when the bit of the code of x is set;
// leaves (left_child < 0) self-loop in the reference, so the walk stops at
// the first leaf, which is the same function.
//
// Categorical codes follow numpy's float32 -> int64 cast, which the
// reference CPU engines use: NaN, +-inf and |x| >= 2^63 become INT64_MIN,
// which the clip to [0, 255] makes 0. A plain (long long)x would saturate
// +inf to INT64_MAX (code 255) and map NaN to 0, so the rule is written
// out in cat_code.

#pragma once

#include <stdint.h>

namespace forest_traverse {

constexpr int kMaskWords = 8;

__device__ __forceinline__ int cat_code(float x) {
  if (isnan(x) || x >= 9223372036854775808.0f || x < -9223372036854775808.0f)
    return 0;
  return static_cast<int>(fminf(fmaxf(x, 0.0f), 255.0f));
}

// The final node (relative to `base`, the tree's first node) after at most
// `depth` rounds from the root, for the example row x. The mask words are
// read as two 16-byte loads, so cat_mask must be 16-byte aligned.
__device__ __forceinline__ int walk(const float* x, long long base, int depth,
                                    const int* __restrict__ feature,
                                    const float* __restrict__ threshold,
                                    const uint32_t* __restrict__ cat_mask,
                                    const int* __restrict__ left_child) {
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
  return node;
}

}  // namespace forest_traverse
