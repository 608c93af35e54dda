// Helpers shared by the per-voxel fit kernels (monoexp_lm.cu, biexp_lm.cu,
// generic_lm.cuh): NaN-propagating min/max and one voxel's echoes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dosma {

// Maxima and minima that propagate NaN, as jnp.maximum and torch.maximum
// (and torch.clamp) do; fmaxf/fminf drop it.
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

// One voxel's echoes and echo times. TT > 0: T is known at compile time
// and both live in registers; TT == 0: read through the pointers.
template <int TT>
struct Voxel {
  const float* __restrict__ xg;
  const float* __restrict__ yg;
  long long st;  // stride between echoes of y, in elements
  int T;
  float xs[TT > 0 ? TT : 1];
  float ys[TT > 0 ? TT : 1];

  Voxel() = default;  // a lane's slot before its first voxel (generic_lm.cuh)
  __device__ __forceinline__ Voxel(const float* x, const float* y, long long stride, int t_rt)
      : xg(x), yg(y), st(stride), T(TT > 0 ? TT : t_rt) {
    if constexpr (TT > 0) {
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        xs[t] = __ldg(x + t);
        ys[t] = __ldg(y + t * stride);
      }
    }
  }
  __device__ __forceinline__ float X(int t) const {
    if constexpr (TT > 0) return xs[t]; else return __ldg(xg + t);
  }
  __device__ __forceinline__ float Y(int t) const {
    if constexpr (TT > 0) return ys[t]; else return __ldg(yg + t * st);
  }
};

// Echo counts with their own kernel instantiation (echoes in registers);
// any other T takes the TT = 0 instantiation.
constexpr int kMaxRegisterEchoes = 8;
constexpr int kThreads = 256;

}  // namespace dosma
