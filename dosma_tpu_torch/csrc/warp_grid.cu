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
// What bounds it on an H100: memory for order 1 (4 x 384x384x160 f32: 377
// MB read, 377 MB written, 0.23 ms at 3.35 TB/s); for order 3 the 64 taps a
// point and volume, which no layout lets a general affine share between
// neighbouring points: 64 shared-memory wavefronts per warp, point and
// volume cap it near 0.8 ms at that size, above its 0.23 ms bound. The TPU
// kernel DMAs a 24x24xS2 block per 8x8 output tile and contracts dense
// banded weight matrices on the MXU. Here:
//
// - One block of 512 threads per output tile (order 1: 8x16x32 points,
//   order 3: 8x8x32), lanes along the contiguous k axis (coalesced stores,
//   conflict-free shared reads under maps close to the identity). Tile
//   coordinates come from blockIdx; index arithmetic inside a volume is
//   32-bit (the wrapper refuses volumes of 2^31 elements or more).
// - Under an affine every tile's source footprint has the same extent,
//   only translated. The block maps its tile's 8 corners through B and
//   takes the box of source elements any of its taps can touch (widened by
//   kBoxMargin for rounding, then by the taps: order 1 floor .. floor + 1,
//   clipped to the volume; order 3 the clipped coordinate's floor - 1 ..
//   floor + 2). It stages that box in shared memory with cp.async, as
//   many of the group's volumes at once as a buffer of kBoxCap floats holds
//   (two at the knee size), and double-buffers: the next volumes load
//   while these are sampled. Each thread computes a point's coordinate and
//   weights once for all the volumes in the buffer. Two buffers take 112
//   KB, so two blocks (32 warps) share an SM. The tiles are small enough
//   for a buffer to hold two boxes at the knee size (4 x 384x384x160 under
//   bench.py's rotation); the price is a read amplification (box over
//   tile) of 1.33 (order 1) and 2.18 (order 3) there, paid from L2.
// - An order-1 block whose box lies inside the volume (most blocks of a
//   large volume) samples without the per-corner masks: none can apply.
// - A block whose box does not fit in kBoxCap floats (zoom, strong shear),
//   whose corners are not finite (a NaN or infinite B), or whose coordinates
//   could round by more than the margin (a coordinate's sum of |terms| of
//   kCoordLimit or more) takes the gather branch of the same kernel: each thread computes
//   a point's coordinate and taps once and reads every volume of its group
//   through the read-only cache. The decision is made per block on the
//   card, so the launch needs no host sync; ops/warp.py::warp_branches
//   repeats it on the host.
// - Order 3 sums separably: 12 weights (4 an axis), the taps reduced along
//   k, then j, then i.
//
// Built with -fmad=false (ops/_build.py), like the other kernels: every
// product and sum is rounded on its own, in the order of the plain version
// (dosma_tpu_torch/ops/warp.py::warp_grid_reference), so the two agree bit
// for bit. A build with FMA contraction (measured, not built by the port)
// moves an order-3 sum that cancels coefficients of ~1e3
// down to a value near 0 by up to ~4e-4, beyond the 1e-5 * max(1, |v|) the
// port holds its kernels to. The moving coordinate is rounded product by product
// (__fmul_rn, __fadd_rn) in either build, so its taps and masks never move.
//
// Volumes come in G groups of V (blockIdx.y = group); group g uses the 3x4
// matrix B + 12 g.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // two blocks an SM: 32 warps hide the shared-memory latency
constexpr int kWarps = kThreads / 32;
constexpr int kBoxCap = 14336;              // floats a staging buffer holds (56 KB); two
constexpr float kBoxMargin = 1.0f / 64.0f;  // around the corners' coordinates
// A coordinate is 6 rounded operations on partial sums below kCoordLimit =
// 2^15, each off by at most half an ulp there, 2^-10; an interior point and
// the corner that bounds it can err in opposite directions, 12 half-ulps or
// 0.0117 in all, and subtracting the margin rounds by another 2^-10: the
// 0.0156 margin covers both, so every tap's floor lies inside the box.
constexpr float kCoordLimit = 32768.0f;

// Output points a tile (keep in step with ops/warp.py::_TILE).
template <int ORDER>
struct Tile;
template <>
struct Tile<1> {
  static constexpr int I = 8, J = 16, K = 32;
};
template <>
struct Tile<3> {
  static constexpr int I = 8, J = 8, K = 32;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One moving coordinate, ((b0 i + b1 j) + b2 k) + b3, each step rounded.
__device__ __forceinline__ float coord(const float* b, float fi, float fj, float fk) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(b[0], fi), __fmul_rn(b[1], fj)),
                             __fmul_rn(b[2], fk)),
                   b[3]);
}

// The cubic B-spline B3 on |t| < 1 and on 1 <= |t| <= 2, as the plain
// version's _b3 evaluates its two branches.
__device__ __forceinline__ float b3_near(float t) {
  const float at = fabsf(t);
  const float at2 = at * at;
  return (4.0f - 6.0f * at2 + 3.0f * (at2 * at)) / 6.0f;
}

__device__ __forceinline__ float b3_far(float t) {
  const float u = 2.0f - fabsf(t);
  return ((u * u) * u) / 6.0f;
}

// B3 at t + 1, t, t - 1 and t - 2 for a fraction t in [0, 1). Each argument
// lies on a known side of |t| = 1, and at the edges (|t| = 1, |t| = 2) the
// two branches give the same float, so each weight is one branch of _b3,
// to the bit.
__device__ __forceinline__ void b3_weights(float t, float (&w)[4]) {
  w[0] = b3_far(t + 1.0f);
  w[1] = b3_near(t);
  w[2] = b3_near(t - 1.0f);
  w[3] = b3_far(t - 2.0f);
}

template <bool STAGED>
__device__ __forceinline__ float ld(const float* p, int i) {
  if constexpr (STAGED) return p[i]; else return __ldg(p + i);
}

// Where a source's element (x0, x1, x2) lies in memory: the staged box
// (origin lo, rows of n2, planes of n1 rows) or the whole volume (lo = 0).
struct Frame {
  int lo[3];
  int n1, n2;
  __device__ __forceinline__ int at(int x0, int x1, int x2) const {
    return ((x0 - lo[0]) * n1 + (x1 - lo[1])) * n2 + (x2 - lo[2]);
  }
};

template <class T>
struct Tag {
  using type = T;
};

// The taps and weights of one output point.
template <int ORDER>
struct Taps;

template <>
struct Taps<1> {
  float wt[8];
  int off[8];
  bool valid[8];

  __device__ __forceinline__ Taps(const float (&c)[3], const int (&dims)[3], const float*,
                                  const Frame& f) {
    int idx[3][2];
    bool ok[3][2];
    float w[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float fl = floorf(c[a]);
      const float t = c[a] - fl;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float at = fl + (float)s;
        ok[a][s] = (at >= 0.0f) && (at <= (float)(dims[a] - 1));
        idx[a][s] = ok[a][s] ? (int)at : f.lo[a];
      }
      w[a][0] = 1.0f - t;
      w[a][1] = t;
    }
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
          off[n] = f.at(idx[0][a], idx[1][b], idx[2][k]);
        }
      }
  }

  template <bool STAGED>
  __device__ __forceinline__ float sample(const float* p, const Frame&) const {
    float acc = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) acc = acc + (valid[n] ? wt[n] * ld<STAGED>(p, off[n]) : 0.0f);
    return acc;
  }
};

// Order 1 in a block whose box lies inside the volume on every axis: every
// corner of every point is in range, so no corner is masked (the sum is
// the masked one's to the bit) and the 8 offsets are one base plus the box
// strides.
struct TapsInterior {
  float wt[8];
  int base;

  __device__ __forceinline__ TapsInterior(const float (&c)[3], const int (&)[3], const float*,
                                          const Frame& f) {
    int idx[3];
    float w[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float fl = floorf(c[a]);
      const float t = c[a] - fl;
      idx[a] = (int)fl;
      w[a][0] = 1.0f - t;
      w[a][1] = t;
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float wab = w[0][a] * w[1][b];
#pragma unroll
        for (int k = 0; k < 2; ++k) wt[4 * a + 2 * b + k] = wab * w[2][k];
      }
    base = f.at(idx[0], idx[1], idx[2]);
  }

  template <bool STAGED>
  __device__ __forceinline__ float sample(const float* p, const Frame& f) const {
    const int plane = f.n1 * f.n2;
    const float* q[4] = {p + base, p + base + f.n2, p + base + plane, p + base + plane + f.n2};
    float acc = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      acc = acc + wt[2 * n] * q[n][0];
      acc = acc + wt[2 * n + 1] * q[n][1];
    }
    return acc;
  }
};

template <>
struct Taps<3> {
  float w[3][4];
  int off;  // the first tap (floor - 1 of each axis, padded frame)
  bool inside;

  __device__ __forceinline__ Taps(const float (&x)[3], const int (&dims)[3], const float* hi,
                                  const Frame& f) {
    inside = true;
    int base[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      inside = inside && (x[a] >= -1e-3f) && (x[a] <= hi[a]);
      // fmaxf drops a NaN: such a point is outside and masked to 0 below.
      const float c = fminf(fmaxf(x[a], 0.0f), (float)(dims[a] - 1));
      const float fl = floorf(c);
      const float t = c - fl;
      base[a] = (int)fl + 1;
      b3_weights(t, w[a]);
    }
    off = f.at(base[0], base[1], base[2]);
  }

  template <bool STAGED>
  __device__ __forceinline__ float sample(const float* p, const Frame& f) const {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float q = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = off + (a * f.n1 + b) * f.n2;
        float s = w[2][0] * ld<STAGED>(p, r);
#pragma unroll
        for (int d = 1; d < 4; ++d) s = s + w[2][d] * ld<STAGED>(p, r + d);
        q = b == 0 ? w[1][0] * s : q + w[1][b] * s;
      }
      acc = a == 0 ? w[0][0] * q : acc + w[0][a] * q;
    }
    return inside ? acc : 0.0f;
  }
};

template <int ORDER>
__global__ void __launch_bounds__(kThreads, 2)
warp_tiles(const float* __restrict__ src, const float* __restrict__ Bm, float* __restrict__ out,
           int per_group, int s0, int s1, int s2, int o0, int o1, int o2, float hi0, float hi1,
           float hi2) {
  using T = Tile<ORDER>;
  static_assert(T::K == 32, "lanes run along k");
  extern __shared__ float smem[];  // two staging buffers of kBoxCap floats

  const int ntk = (o2 + T::K - 1) / T::K, ntj = (o1 + T::J - 1) / T::J;
  const int tk = (int)(blockIdx.x % (unsigned)ntk);
  const int rest = (int)(blockIdx.x / (unsigned)ntk);
  const int tj = rest % ntj, ti = rest / ntj;
  const int i0 = ti * T::I, j0 = tj * T::J, k0 = tk * T::K;
  const int i1 = min(i0 + T::I, o0) - 1, j1 = min(j0 + T::J, o1) - 1, k1 = min(k0 + T::K, o2) - 1;
  const int g = blockIdx.y;
  float b[12];
#pragma unroll
  for (int n = 0; n < 12; ++n) b[n] = __ldg(Bm + 12 * g + n);
  const int pad = ORDER == 3 ? 4 : 0;
  const int dims[3] = {s0 - pad, s1 - pad, s2 - pad};
  const float hi[3] = {hi0, hi1, hi2};

  // The tile's box, and whether it is staged.
  const float ext[3] = {(float)(o0 - 1), (float)(o1 - 1), (float)(o2 - 1)};
  bool staged = true;
  bool interior = ORDER == 1;  // every order-1 tap of the block in range
  Frame box;
  int n0 = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* r = b + 4 * a;
    const float lim = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(fabsf(r[0]), ext[0]),
                                                    __fmul_rn(fabsf(r[1]), ext[1])),
                                          __fmul_rn(fabsf(r[2]), ext[2])),
                                fabsf(r[3]));
    staged = staged && (lim < kCoordLimit);
    float cmin = INFINITY, cmax = -INFINITY;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const float c = coord(r, (float)((corner & 4) ? i1 : i0), (float)((corner & 2) ? j1 : j0),
                            (float)((corner & 1) ? k1 : k0));
      staged = staged && isfinite(c);
      cmin = fminf(cmin, c);
      cmax = fmaxf(cmax, c);
    }
    const float top = (float)(dims[a] - 1);
    int lo = 0, hi_ = -1;
    if (staged) {
      if (ORDER == 3) {
        cmin = fminf(fmaxf(cmin, 0.0f), top);
        cmax = fminf(fmaxf(cmax, 0.0f), top);
        lo = (int)floorf(__fsub_rn(cmin, kBoxMargin)) + 1;
        hi_ = (int)floorf(__fadd_rn(cmax, kBoxMargin)) + 4;
      } else {
        const int raw_lo = (int)floorf(__fsub_rn(cmin, kBoxMargin));
        const int raw_hi = (int)floorf(__fadd_rn(cmax, kBoxMargin)) + 1;
        interior = interior && raw_lo >= 0 && raw_hi <= dims[a] - 1;
        lo = max(raw_lo, 0);
        hi_ = min(raw_hi, dims[a] - 1);
      }
    }
    const int n = max(hi_ - lo + 1, 0);
    staged = staged && (n <= kBoxCap);
    box.lo[a] = lo;
    if (a == 0) n0 = n;
    if (a == 1) box.n1 = n;
    if (a == 2) box.n2 = n;
  }
  staged = staged && ((long long)n0 * box.n1 * box.n2 <= kBoxCap);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = k0 + lane;
  const float fk = (float)k;
  const int vol = s0 * s1 * s2;
  const int npts = o0 * o1 * o2;
  const float* gsrc = src + (size_t)g * per_group * vol;
  float* gout = out + (size_t)g * per_group * npts;

  if (staged) {
    // Volumes a buffer holds (an empty box, a tile wholly outside an order-1
    // source, holds any number), and the groups of that many volumes that
    // the two buffers take in turns.
    const int elems = n0 * box.n1 * box.n2;
    const int per_buf = elems > 0 ? min(kBoxCap / elems, per_group) : per_group;
    // Thread t copies elements t, t + kThreads, ... of the box, row-major:
    // its (i, j, k) in the box advances by the same (di, dj, dk) each step,
    // with carries, so the copy loop does no division.
    const int n1 = max(box.n1, 1), n2 = max(box.n2, 1);
    const int dk = kThreads % n2, dr = kThreads / n2, dj = dr % n1, di = dr / n1;
    const int k_start = threadIdx.x % n2, r_start = threadIdx.x / n2;
    auto load = [&](int v0, float* dst) {
      const int nv = min(per_buf, per_group - v0);
      for (int u = 0; u < nv; ++u) {
        const float* s = gsrc + (size_t)(v0 + u) * vol + (box.lo[0] * s1 + box.lo[1]) * s2 +
                         box.lo[2];
        float* d = dst + u * elems;
        int kk = k_start, jj = r_start % n1, ii = r_start / n1;
        for (int e = threadIdx.x; e < elems; e += kThreads) {
          cp_async4(d + e, s + (ii * s1 + jj) * s2 + kk);
          kk += dk;
          jj += dj;
          ii += di;
          if (kk >= n2) {
            kk -= n2;
            ++jj;
          }
          if (jj >= n1) {
            jj -= n1;
            ++ii;
          }
        }
      }
      cp_async_commit();
    };
    load(0, smem);
    for (int v0 = 0, half = 0; v0 < per_group; v0 += per_buf, half ^= 1) {
      if (v0 + per_buf < per_group) {
        load(v0 + per_buf, smem + (half ^ 1) * kBoxCap);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* buf = smem + half * kBoxCap;
      const int nv = min(per_buf, per_group - v0);
      auto sweep = [&](auto tag) {
        using TP = typename decltype(tag)::type;
        for (int r = warp; r < T::I * T::J; r += kWarps) {
          const int i = i0 + r / T::J, j = j0 + r % T::J;
          if (i > i1 || j > j1) continue;
          const float fi = (float)i, fj = (float)j;
          const float c[3] = {coord(b, fi, fj, fk), coord(b + 4, fi, fj, fk),
                              coord(b + 8, fi, fj, fk)};
          const TP tp(c, dims, hi, box);
          float* o = gout + (size_t)v0 * npts + (i * o1 + j) * o2 + k;
          for (int u = 0; u < nv; ++u)
            o[(size_t)u * npts] = tp.template sample<true>(buf + u * elems, box);
        }
      };
      if (k <= k1) {
        if constexpr (ORDER == 1) {
          if (interior) sweep(Tag<TapsInterior>{}); else sweep(Tag<Taps<1>>{});
        } else {
          sweep(Tag<Taps<3>>{});
        }
      }
      __syncthreads();  // the buffer is refilled by the next group's load
    }
  } else {
    const Frame whole = {{0, 0, 0}, s1, s2};
    if (k > k1) return;
    for (int r = warp; r < T::I * T::J; r += kWarps) {
      const int i = i0 + r / T::J, j = j0 + r % T::J;
      if (i > i1 || j > j1) continue;
      const float fi = (float)i, fj = (float)j;
      const float c[3] = {coord(b, fi, fj, fk), coord(b + 4, fi, fj, fk),
                          coord(b + 8, fi, fj, fk)};
      const Taps<ORDER> tp(c, dims, hi, whole);
      const int p = (i * o1 + j) * o2 + k;
      for (int v = 0; v < per_group; ++v)
        gout[(size_t)v * npts + p] = tp.template sample<false>(gsrc + (size_t)v * vol, whole);
    }
  }
}

template <int ORDER>
int launch(const float* src, const float* B, float* out, int groups, int per_group, int s0,
           int s1, int s2, int o0, int o1, int o2, float hi0, float hi1, float hi2,
           cudaStream_t st) {
  using T = Tile<ORDER>;
  const long long tiles = (long long)((o0 + T::I - 1) / T::I) * ((o1 + T::J - 1) / T::J) *
                          ((o2 + T::K - 1) / T::K);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int smem = 2 * kBoxCap * (int)sizeof(float);
  // Once per device: the dynamic shared memory, and all of the SM's unified
  // memory as shared memory, so that two blocks fit.
  static unsigned long long configured = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 64 && !(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(warp_tiles<ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(warp_tiles<ORDER>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err == cudaSuccess) configured |= 1ull << dev;
  }
  if (err != cudaSuccess) return (int)err;
  warp_tiles<ORDER><<<dim3((unsigned)tiles, (unsigned)groups), kThreads, smem, st>>>(
      src, B, out, per_group, s0, s1, s2, o0, o1, o2, hi0, hi1, hi2);
  return (int)cudaGetLastError();
}

}  // namespace

// src: G*V volumes of (s0, s1, s2) f32, contiguous (order 3: padded by 2);
// B: (G, 3, 4) f32 on the device; out: G*V volumes of (o0, o1, o2). Each
// volume has fewer than 2^31 elements. hi*: the order-3 in-domain upper
// limits (D-1) + 1e-3, rounded to float32 by the caller exactly as the plain
// version rounds them. Launches on `stream`, does not synchronise, and
// returns the CUDA error of the launch (0 on success).
extern "C" int dosma_warp_grid(const float* src, const float* B, float* out, int groups,
                               int per_group, int s0, int s1, int s2, int o0, int o1, int o2,
                               int order, float hi0, float hi1, float hi2, void* stream) {
  const long long npts = (long long)o0 * o1 * o2;
  if (npts == 0 || groups == 0 || per_group == 0) return 0;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (order == 1)
    return launch<1>(src, B, out, groups, per_group, s0, s1, s2, o0, o1, o2, hi0, hi1, hi2, st);
  if (order == 3)
    return launch<3>(src, B, out, groups, per_group, s0, s1, s2, o0, o1, o2, hi0, hi1, hi2, st);
  return (int)cudaErrorInvalidValue;
}
