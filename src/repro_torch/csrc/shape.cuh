// Shape-function helpers shared by the fused deposition and gather kernels.
//
// Mirrors repro_torch/core/shape_functions.py: the B-spline of each order,
// the order's unified tap window (T, base) and the six 1-D weight sets
// (axis x staggered) every fused kernel evaluates per particle. Each
// arithmetic step rounds once (no contraction into a fused multiply-add),
// as the plain PyTorch version evaluates it, so kernel and plain weights
// agree to the bit wherever the divisor rounds alike.
#pragma once

#include <cuda_runtime.h>

namespace mpic {

// unified_support(order): the smallest tap window covering the staggered
// and the unstaggered support of the order
template <int ORDER> struct Window;
template <> struct Window<1> { static constexpr int T = 3, BASE = -1; };
template <> struct Window<2> { static constexpr int T = 4, BASE = -1; };
template <> struct Window<3> { static constexpr int T = 5, BASE = -2; };

// centered B-spline of ORDER at signed distance u
template <int ORDER>
__device__ __forceinline__ float bspline(float u) {
  const float a = fabsf(u);
  if constexpr (ORDER == 1) {
    return fmaxf(__fsub_rn(1.0f, a), 0.0f);
  } else if constexpr (ORDER == 2) {
    if (a < 0.5f) return __fsub_rn(0.75f, __fmul_rn(a, a));
    if (a < 1.5f) {
      const float t = __fsub_rn(1.5f, a);
      return __fmul_rn(0.5f, __fmul_rn(t, t));
    }
    return 0.0f;
  } else {
    if (a < 1.0f) {
      // 2/3 - a*a + 0.5*a*a*a, evaluated left to right
      const float two_thirds = static_cast<float>(2.0 / 3.0);
      return __fadd_rn(__fsub_rn(two_thirds, __fmul_rn(a, a)),
                       __fmul_rn(__fmul_rn(__fmul_rn(0.5f, a), a), a));
    }
    if (a < 2.0f) {
      const float t = __fsub_rn(2.0f, a);
      return __fdiv_rn(__fmul_rn(__fmul_rn(t, t), t), 6.0f);
    }
    return 0.0f;
  }
}

// one 1-D weight set on the unified window:
// w[j] = bspline(d - (BASE + j + (staggered ? 1/2 : 0))), j < T
template <int ORDER>
__device__ __forceinline__ void weights(float d, int staggered, float* w) {
  constexpr int T = Window<ORDER>::T, BASE = Window<ORDER>::BASE;
  const float shift = staggered ? 0.5f : 0.0f;
#pragma unroll
  for (int j = 0; j < T; ++j) w[j] = bspline<ORDER>(__fsub_rn(d, static_cast<float>(BASE + j) + shift));
}

}  // namespace mpic
