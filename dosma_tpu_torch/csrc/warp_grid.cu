// Full-grid affine warp of a stack of same-grid volumes (order 1 or 3).
//
// Replaces dosma_tpu/ops/warp_pallas.py::_kernel (pallas_call in
// _warp_grid_pallas, via warp_grid_batched): the final resample of
// registration and of apply_warp. Output point (i, j, k) of volume v takes
// the moving coordinate c = B[:, :3] @ (i, j, k) + B[:, 3] and samples
//   order 1: the unpadded source trilinearly, each of the 8 corners 0 when
//            it lies outside (map_coordinates(mode="constant")), no clip;
//   order 3: the prefiltered coefficients, mirror-padded by 2, with the
//            cubic B-spline over 4x4x4 taps; c is clipped to [0, D-1] (so
//            every tap is in range and needs no branch) and the point is 0
//            outside [-1e-3, D-1+1e-3].
//
// What bounds it on an H100: memory. Each source is read at least once and
// each output written once (4 x 384x384x160 f32: 377 MB each way, 0.23 ms
// at 3.35 TB/s); the arithmetic is ~50 (order 1) to ~260 (order 3) flops a
// point plus 16 or 128 per volume. The TPU kernel DMAs a 24x24xS2 block
// per 8x8 output tile and contracts dense banded weight matrices on the
// MXU, because the TPU has no gather. Hopper has cached gathers, so this is
// a direct point kernel: one thread per output point, neighbouring threads
// along the contiguous k axis (coalesced stores, spatially coherent __ldg
// tap loads that mostly hit L1/L2). Each thread computes its coordinate
// and its 8 or 64 tap weights once and reuses them for every volume of its
// group, which is why the callers batch volumes that share a transform.
// There is no limit on the number of volumes and any output shape works.
//
// Volumes come in G groups of V (blockIdx.y = group); group g uses the
// 3x4 matrix B + 12 g. Built with -fmad=false: every product and sum is
// rounded on its own, in the order of the plain version
// (dosma_tpu_torch/ops/warp.py::warp_grid_reference), so the two agree
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float b3(float t) {
  const float at = fabsf(t);
  const float at2 = at * at;
  const float near_ = (4.0f - 6.0f * at2 + 3.0f * (at2 * at)) / 6.0f;
  const float u = 2.0f - at;
  const float far_ = ((u * u) * u) / 6.0f;
  return at < 1.0f ? near_ : (at < 2.0f ? far_ : 0.0f);
}

struct Point {
  float c[3];
};

__device__ __forceinline__ Point moving_coord(const float* __restrict__ b, long long p,
                                              int o1, int o2) {
  const int ok = (int)(p % o2);
  const long long r = p / o2;
  const int oj = (int)(r % o1);
  const int oi = (int)(r / o1);
  const float fi = (float)oi, fj = (float)oj, fk = (float)ok;
  Point q;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* row = b + 4 * a;
    q.c[a] = __ldg(row) * fi + __ldg(row + 1) * fj + __ldg(row + 2) * fk + __ldg(row + 3);
  }
  return q;
}

__global__ void __launch_bounds__(kThreads)
warp_linear(const float* __restrict__ src, const float* __restrict__ B, float* __restrict__ out,
            int per_group, int d0, int d1, int d2, int o0, int o1, int o2) {
  const long long npts = (long long)o0 * o1 * o2;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= npts) return;
  const int g = blockIdx.y;
  const Point q = moving_coord(B + 12 * g, p, o1, o2);
  const int dims[3] = {d0, d1, d2};

  int idx[3][2];
  bool ok[3][2];
  float w[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float fl = floorf(q.c[a]);
    const float t = q.c[a] - fl;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float at = fl + (float)s;
      ok[a][s] = (at >= 0.0f) && (at <= (float)(dims[a] - 1));
      idx[a][s] = ok[a][s] ? (int)at : 0;
    }
    w[a][0] = 1.0f - t;
    w[a][1] = t;
  }
  float wt[8];
  long long off[8];
  bool valid[8];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wab = w[0][a] * w[1][b];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int n = 4 * a + 2 * b + k;
        wt[n] = wab * w[2][k];
        valid[n] = ok[0][a] && ok[1][b] && ok[2][k];
        off[n] = ((long long)idx[0][a] * d1 + idx[1][b]) * d2 + idx[2][k];
      }
    }

  const long long vol_elems = (long long)d0 * d1 * d2;
  for (int v = 0; v < per_group; ++v) {
    const long long vid = (long long)g * per_group + v;
    const float* s = src + vid * vol_elems;
    float acc = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc = acc + (valid[n] ? wt[n] * __ldg(s + off[n]) : 0.0f);
    }
    out[vid * npts + p] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
warp_cubic(const float* __restrict__ src, const float* __restrict__ B, float* __restrict__ out,
           int per_group, int p0, int p1, int p2, int o0, int o1, int o2,
           float hi0, float hi1, float hi2) {
  const long long npts = (long long)o0 * o1 * o2;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= npts) return;
  const int g = blockIdx.y;
  const Point q = moving_coord(B + 12 * g, p, o1, o2);
  const int dims[3] = {p0 - 4, p1 - 4, p2 - 4};
  const float hi[3] = {hi0, hi1, hi2};

  bool inside = true;
  int base[3];
  float w[3][4];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = q.c[a];
    inside = inside && (x >= -1e-3f) && (x <= hi[a]);
    // fmaxf drops a NaN: such a point is outside and masked to 0 below.
    const float c = fminf(fmaxf(x, 0.0f), (float)(dims[a] - 1));
    const float fl = floorf(c);
    const float t = c - fl;
    base[a] = (int)fl + 1;  // first tap (floor - 1) in padded coordinates
    w[a][0] = b3(t + 1.0f);
    w[a][1] = b3(t);
    w[a][2] = b3(t - 1.0f);
    w[a][3] = b3(t - 2.0f);
  }
  float wt[64];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float wab = w[0][a] * w[1][b];
#pragma unroll
      for (int d = 0; d < 4; ++d) wt[16 * a + 4 * b + d] = wab * w[2][d];
    }
  const long long row0 = ((long long)base[0] * p1 + base[1]) * p2 + base[2];

  const long long vol_elems = (long long)p0 * p1 * p2;
  for (int v = 0; v < per_group; ++v) {
    const long long vid = (long long)g * per_group + v;
    const float* s = src + vid * vol_elems + row0;
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float* r = s + ((long long)a * p1 + b) * p2;
#pragma unroll
        for (int d = 0; d < 4; ++d) acc = acc + wt[16 * a + 4 * b + d] * __ldg(r + d);
      }
    out[vid * npts + p] = inside ? acc : 0.0f;
  }
}

}  // namespace

// src: G*V volumes of (s0, s1, s2) f32, contiguous (order 3: padded by 2);
// B: (G, 3, 4) f32 on the device; out: G*V volumes of (o0, o1, o2).
// hi*: the order-3 in-domain upper limits (D-1) + 1e-3, rounded to float32
// by the caller exactly as the plain version rounds them. Returns the CUDA
// error of the launch (0 on success).
extern "C" int dosma_warp_grid(const float* src, const float* B, float* out, int groups,
                               int per_group, int s0, int s1, int s2, int o0, int o1, int o2,
                               int order, float hi0, float hi1, float hi2, void* stream) {
  const long long npts = (long long)o0 * o1 * o2;
  if (npts == 0 || groups == 0 || per_group == 0) return 0;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((npts + kThreads - 1) / kThreads), (unsigned)groups);
  cudaStream_t st = (cudaStream_t)stream;
  if (order == 1) {
    warp_linear<<<grid, kThreads, 0, st>>>(src, B, out, per_group, s0, s1, s2, o0, o1, o2);
  } else if (order == 3) {
    warp_cubic<<<grid, kThreads, 0, st>>>(src, B, out, per_group, s0, s1, s2, o0, o1, o2, hi0,
                                          hi1, hi2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
