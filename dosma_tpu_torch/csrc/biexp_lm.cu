// Per-voxel biexponential fit y = a1 * exp(b1 * x) + a2 * exp(b2 * x) by
// Levenberg-Marquardt on all four parameters.
//
// Replaces dosma_tpu/ops/biexp_pallas.py::_kernel (with _chol4_solve). The
// plain PyTorch version of the same algorithm, which the tests and the chip
// smoke test hold this kernel against, is
// dosma_tpu_torch/ops/biexp.py::_packed_reference.
//
// What bounds it on an H100: instructions issued. A voxel costs T*4 bytes
// of echoes and 16 bytes of seeds in, 24 bytes of packed results out (64
// bytes at T = 8; ~270 MB at 4.2M voxels, 0.08 ms at 3.35 TB/s), against
// ~710 SASS instructions an LM iteration at T = 8 (every multiply and add
// its own instruction): the 10 + 4 sums of the normal equations, the
// proposal's columns and residuals, a 4x4 Cholesky with 4 square roots
// and 4 reciprocals, and the step ratio's 4 divisions; ~5.3 iterations a
// voxel, and a warp runs as long as its slowest voxel (1.15x the mean on
// bench data). Measured on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit: 0.63 ms for 4.19M voxels x 8 echoes of noiseless bench data
// (chip_smoke.py phase 5, tools/compare_kernels.py).
// The design spends as few instructions as the plain version's operations
// allow and keeps enough warps resident to hide the Cholesky's serial
// chain:
//   - one thread per voxel; the voxel axis of y (T, N) is contiguous, so
//     each echo row is read coalesced across a warp, and the six output
//     rows of (6, N) are written coalesced;
//   - for T <= 8 the kernel is instantiated per T, and the voxel's echoes
//     and, at the accepted parameters, both exponential columns, the
//     residuals and the raw cost live in registers (Point): the normal
//     equations read the residuals the accepted proposal's cost already
//     computed, and r^2 takes its residual sum from the raw cost. Any
//     other T re-reads y from global memory (L1/L2 resident after the
//     first pass) and recomputes columns and residuals from the accepted
//     parameters: the same operations on the same values, so the same bits;
//   - the echo times, the same for every voxel, are loaded once a block
//     into shared memory. ptxas keeps the LM loop's reads of them in
//     registers; forcing a shared-memory read at every use (volatile)
//     saved 8 registers but was slower (0.67-0.68 against 0.63-0.64 ms);
//   - uniformly spaced echoes (3 <= T <= 8) build each column as e0 * q^t,
//     as monoexp_lm.cu does: four expf a proposal instead of 2T;
//   - 128 threads a block and at least five blocks an SM: the ~94 registers
//     a thread needs then leave 20 warps resident, where 256-thread blocks
//     leave 16 (tools/compare_kernels.py --sweep: 0.63-0.64 against 0.69 ms);
//   - the ragged edge is masked in the kernel, so no pad voxels exist (the
//     TPU kernel padded with y = 1 and seed (1, 0, 0, 0)).
// Each thread iterates until its own voxel latches or max_iter, and a
// latched voxel is frozen: its result does not depend on its neighbours.
// (The TPU kernel kept polishing latched lanes until its 8192-voxel block
// had latched.)
//
// Semantics kept from the TPU kernel: closed-form Jacobian columns
// [e1, a1 x e1, e2, a2 x e2]; damping d + lam * max(d, 1e-12) on the
// diagonal; the unrolled Cholesky with pivots clamped at 1e-30 and solved
// through reciprocals; accept new_cost <= cost when finite; latch on the
// predicted reduction dp.g <= ftol * max(cost, 1e-30) or a largest step
// ratio |dp| / max(|p|, 1e-12) <= xtol; lam * 0.33 (floor 1e-12) on accept,
// * 10 (cap 1e10) on reject; a voxel whose initial cost is not finite
// starts from cost = inf (not latched); converged = latched * finite *
// (1 - bad_init); r2 = 1 - ss_res / (ss_tot + 1e-8). Maxima propagate NaN.
//
// Built with -fmad=false (ops/_build.py), and every sum over echoes runs in
// order t = 0, 1, ..., T-1, as the plain version's: the two round every
// operation alike. An FMA build measured 14% faster (0.54 against 0.63 ms
// on the card above) and stayed within 1e-5 of it on the bench data, but
// is not bit-equal to the plain version; the port has no such build.

#include "lm_common.cuh"

namespace {

using dosma::nmax;
using dosma::nmin;
using dosma::Voxel;

// Threads a block, and the fewest blocks an SM must hold at once, which caps
// the registers a thread may use (ptxas's report: chip_smoke.py phase 5;
// the measured choice: see above).
constexpr int kThreads = 128;
constexpr int kMinBlocks = 5;

// Echo times: one copy a block in shared memory for T <= 8, read through
// the pointer otherwise.
template <int TT>
struct Times {
  const float* xp;
  __device__ __forceinline__ float operator()(int t) const {
    if constexpr (TT > 0) return xp[t]; else return __ldg(xp + t);
  }
};

// The exponential columns exp(b x_t) of one rate, produced in order t = 0,
// 1, ..., T-1 by at(). Uniformly spaced echoes (UNI) multiply by q =
// exp(b dx) as monoexp_lm.cu's columns do: two expf a column instead of T.
template <bool UNI>
struct ECols {
  float b, cur, q;
  __device__ __forceinline__ ECols(float b_, float x0, float dx) : b(b_), cur(0.f), q(0.f) {
    if constexpr (UNI) {
      cur = expf(b * x0);
      q = expf(b * dx);
    }
  }
  __device__ __forceinline__ float at(int t, float xt) {
    if constexpr (UNI) {
      if (t > 0) cur = cur * q;
      return cur;
    } else {
      return expf(b * xt);
    }
  }
};

// One parameter point's columns e1, e2 and residuals r = a1 e1 + a2 e2 - y
// (T <= 8: in registers; T > 8 recomputes them from the rates on every
// read, with the same operations, so the same bits), and the raw cost
// sum r^2: the accepted point's feed the normal equations, and its raw
// cost is r^2's residual sum.
template <int TT>
struct Point {
  float e1[TT > 0 ? TT : 1];
  float e2[TT > 0 ? TT : 1];
  float r[TT > 0 ? TT : 1];
  float raw;
};

template <int TT, bool UNI>
__device__ __forceinline__ void evaluate(const Voxel<TT>& v, const Times<TT>& x, int T, float a1,
                                         float b1, float a2, float b2, Point<TT>& p) {
  const float x0 = x(0), dx = T > 1 ? x(1) - x(0) : x(0);
  ECols<UNI> c1(b1, x0, dx), c2(b2, x0, dx);
  float c = -0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
    const float xt = UNI ? 0.f : x(t);
    const float e1 = c1.at(t, xt);
    const float e2 = c2.at(t, xt);
    const float r = a1 * e1 + a2 * e2 - v.Y(t);
    if constexpr (TT > 0) {
      p.e1[t] = e1;
      p.e2[t] = e2;
      p.r[t] = r;
    }
    c += r * r;
  }
  p.raw = c;
}

__device__ __forceinline__ float mapped(float c) { return isfinite(c) ? c : INFINITY; }

template <int TT, bool UNI>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
biexp_lm_kernel(const float* __restrict__ x, const float* __restrict__ y, long long y_st,
                long long y_sn, const float* __restrict__ p0, long long p0_sp, long long p0_sn,
                float* __restrict__ out, long long N, int T_rt, int max_iter, float ftol,
                float xtol) {
  __shared__ float x_sh[TT > 0 ? TT : 1];
  if constexpr (TT > 0) {
    if (threadIdx.x < TT) x_sh[threadIdx.x] = __ldg(x + threadIdx.x);
    __syncthreads();
  }
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= N) return;

  const Times<TT> xt_of{TT > 0 ? x_sh : x};
  const Voxel<TT> v(x, y + n * y_sn, y_st, T_rt);  // its echoes; x is read through xt_of
  const int T = TT > 0 ? TT : T_rt;

  const float* pv = p0 + n * p0_sn;
  float a1 = __ldg(pv), b1 = __ldg(pv + p0_sp), a2 = __ldg(pv + 2 * p0_sp),
        b2 = __ldg(pv + 3 * p0_sp);

  Point<TT> cur, prop;
  evaluate<TT, UNI>(v, xt_of, T, a1, b1, a2, b2, cur);
  const bool bad_init = !isfinite(cur.raw);

  float lam = 1e-3f;
  bool latched = false;
  for (int it = 0; it < max_iter && !latched; ++it) {
    const float cost = mapped(cur.raw);
    // Normal equations (lower triangle) and gradient, summed over echoes.
    float A11 = -0.0f, A21 = -0.0f, A22 = -0.0f, A31 = -0.0f, A32 = -0.0f, A33 = -0.0f,
          A41 = -0.0f, A42 = -0.0f, A43 = -0.0f, A44 = -0.0f;
    float g1 = -0.0f, g2 = -0.0f, g3 = -0.0f, g4 = -0.0f;
#pragma unroll
    for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
      const float xt = xt_of(t);
      float e1, e2, r;
      if constexpr (TT > 0) {
        e1 = cur.e1[t];
        e2 = cur.e2[t];
        r = cur.r[t];
      } else {
        e1 = expf(b1 * xt);
        e2 = expf(b2 * xt);
        r = a1 * e1 + a2 * e2 - v.Y(t);
      }
      const float j2 = a1 * (xt * e1);
      const float j4 = a2 * (xt * e2);
      A11 += e1 * e1;
      A21 += j2 * e1;
      A22 += j2 * j2;
      A31 += e2 * e1;
      A32 += e2 * j2;
      A33 += e2 * e2;
      A41 += j4 * e1;
      A42 += j4 * j2;
      A43 += j4 * e2;
      A44 += j4 * j4;
      g1 += e1 * r;
      g2 += j2 * r;
      g3 += e2 * r;
      g4 += j4 * r;
    }
    A11 = A11 + lam * nmax(A11, 1e-12f);
    A22 = A22 + lam * nmax(A22, 1e-12f);
    A33 = A33 + lam * nmax(A33, 1e-12f);
    A44 = A44 + lam * nmax(A44, 1e-12f);

    // Unrolled Cholesky; pivots clamped so rank-deficient voxels (b1 == b2)
    // give finite steps that the accept test then judges.
    const float tiny = 1e-30f;
    const float l11 = sqrtf(nmax(A11, tiny));
    const float i11 = 1.0f / l11;
    const float l21 = A21 * i11;
    const float l31 = A31 * i11;
    const float l41 = A41 * i11;
    const float l22 = sqrtf(nmax(A22 - l21 * l21, tiny));
    const float i22 = 1.0f / l22;
    const float l32 = (A32 - l31 * l21) * i22;
    const float l42 = (A42 - l41 * l21) * i22;
    const float l33 = sqrtf(nmax(A33 - l31 * l31 - l32 * l32, tiny));
    const float i33 = 1.0f / l33;
    const float l43 = (A43 - l41 * l31 - l42 * l32) * i33;
    const float l44 = sqrtf(nmax(A44 - l41 * l41 - l42 * l42 - l43 * l43, tiny));
    const float i44 = 1.0f / l44;
    const float z1 = g1 * i11;
    const float z2 = (g2 - l21 * z1) * i22;
    const float z3 = (g3 - l31 * z1 - l32 * z2) * i33;
    const float z4 = (g4 - l41 * z1 - l42 * z2 - l43 * z3) * i44;
    const float d4 = z4 * i44;
    const float d3 = (z3 - l43 * d4) * i33;
    const float d2 = (z2 - l32 * d3 - l42 * d4) * i22;
    const float d1 = (z1 - l21 * d2 - l31 * d3 - l41 * d4) * i11;

    const float na1 = a1 - d1, nb1 = b1 - d2, na2 = a2 - d3, nb2 = b2 - d4;
    evaluate<TT, UNI>(v, xt_of, T, na1, nb1, na2, nb2, prop);
    const float new_cost = mapped(prop.raw);

    // Equal cost is accepted; the latch reads the predicted reduction,
    // which rejections near the f32 cost floor cannot stall.
    const bool accept = (new_cost <= cost) && isfinite(new_cost);
    const float pred = d1 * g1 + d2 * g2 + d3 * g3 + d4 * g4;
    const bool rel_decrease = pred <= ftol * nmax(cost, 1e-30f);
    const float step_ratio =
        nmax(nmax(fabsf(d1) / nmax(fabsf(a1), 1e-12f), fabsf(d2) / nmax(fabsf(b1), 1e-12f)),
             nmax(fabsf(d3) / nmax(fabsf(a2), 1e-12f), fabsf(d4) / nmax(fabsf(b2), 1e-12f)));
    latched = rel_decrease || (step_ratio <= xtol);

    if (accept) {
      a1 = na1;
      b1 = nb1;
      a2 = na2;
      b2 = nb2;
      cur = prop;
    }
    lam = accept ? nmax(lam * 0.33f, 1e-12f) : nmin(lam * 10.0f, 1e10f);
  }

  float ysum = -0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) ysum += v.Y(t);
  const float y_mean = ysum / (float)T;
  float ss_tot = -0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
    const float d = v.Y(t) - y_mean;
    ss_tot += d * d;
  }
  const bool finite = isfinite(a1) && isfinite(b1) && isfinite(a2) && isfinite(b2);

  out[n] = a1;
  out[N + n] = b1;
  out[2 * N + n] = a2;
  out[3 * N + n] = b2;
  out[4 * N + n] = 1.0f - cur.raw / (ss_tot + 1e-8f);
  out[5 * N + n] = (latched && finite && !bad_init) ? 1.0f : 0.0f;
}

template <int TT, bool UNI>
void launch(const float* x, const float* y, long long y_st, long long y_sn, const float* p0,
            long long p0_sp, long long p0_sn, float* out, long long N, int T, int max_iter,
            float ftol, float xtol, cudaStream_t stream) {
  const long long blocks = (N + kThreads - 1) / kThreads;
  biexp_lm_kernel<TT, UNI><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol);
}

}  // namespace

// x (T,) f32; y (T, N) f32 read at y[t * y_st + n * y_sn]; p0 the seeds
// [a1, b1, a2, b2] read at p0[i * p0_sp + n * p0_sn] (p0_sn = 0 broadcasts
// one seed); out (6, N) f32 contiguous, rows [a1, b1, a2, b2, r2,
// converged]. uniform_x != 0 (taken for 3 <= T <= 8) builds the columns
// as e0 * q^t. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int dosma_biexp_lm(const float* x, const float* y, long long y_st, long long y_sn,
                              const float* p0, long long p0_sp, long long p0_sn, float* out,
                              long long N, int T, int max_iter, float ftol, float xtol,
                              int uniform_x, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if ((N + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool uni = uniform_x != 0;
#define DOSMA_BIEXP_ARGS x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, s
#define DOSMA_BIEXP_CASE(TV)                                                             \
  case TV:                                                                               \
    if (uni) launch<TV, true>(DOSMA_BIEXP_ARGS); else launch<TV, false>(DOSMA_BIEXP_ARGS); \
    break;
  switch (T) {
    case 1: launch<1, false>(DOSMA_BIEXP_ARGS); break;
    case 2: launch<2, false>(DOSMA_BIEXP_ARGS); break;
    DOSMA_BIEXP_CASE(3)
    DOSMA_BIEXP_CASE(4)
    DOSMA_BIEXP_CASE(5)
    DOSMA_BIEXP_CASE(6)
    DOSMA_BIEXP_CASE(7)
    DOSMA_BIEXP_CASE(8)
    default: launch<0, false>(DOSMA_BIEXP_ARGS);
  }
#undef DOSMA_BIEXP_CASE
#undef DOSMA_BIEXP_ARGS
  return (int)cudaGetLastError();
}
