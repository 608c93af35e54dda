// Per-voxel biexponential fit y = a1 * exp(b1 * x) + a2 * exp(b2 * x) by
// Levenberg-Marquardt on all four parameters.
//
// Replaces dosma_tpu/ops/biexp_pallas.py::_kernel (with _chol4_solve). The
// plain PyTorch version of the same algorithm, which the tests and the chip
// smoke test hold this kernel against, is
// dosma_tpu_torch/ops/biexp.py::_packed_reference.
//
// What bounds it on an H100: a voxel costs T*4 bytes of echoes and 16 bytes
// of seeds in, 24 bytes of packed results out (64 bytes at T = 8), against
// ~40 f32 operations per echo (the 10 + 4 sums of the normal equations), two
// expf per echo and a 4x4 Cholesky with 4 square roots and 4 divisions per
// LM iteration. At 4.2M voxels memory is ~270 MB, 0.08 ms at 3.35 TB/s; the
// arithmetic of the LM iterations is far more, so it is bound by issue
// rate, and a warp runs as long as its slowest voxel. (Measured: 0.73 ms
// for 4.19M voxels x 8 echoes of noiseless bench data, 0.37 TB/s, on an
// H100 80GB HBM3 at a 700 W power limit; chip_smoke.py phase 5.)
// The design keeps memory at that floor:
//   - one thread per voxel; the voxel axis of y (T, N) is contiguous, so
//     each echo row is read coalesced across a warp, and the six output
//     rows of (6, N) are written coalesced;
//   - for T <= 8 the kernel is instantiated per T: the voxel's echoes, echo
//     times and both exponential columns at the accepted parameters live in
//     registers for the whole fit, so an iteration takes two fresh expf per
//     echo (for the proposal) instead of four. Any other T re-reads y from
//     global memory (L1/L2 resident after the first pass) and recomputes
//     the columns from the accepted rates: exp of the same argument, so the
//     same bits as carrying them, with nothing spilled;
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
// operation alike.

#include "lm_common.cuh"

namespace {

using dosma::nmax;
using dosma::nmin;
using dosma::Voxel;

// The exponential columns at the accepted rates. TT > 0: carried in
// registers; TT == 0: recomputed from b1, b2 on every read.
template <int TT>
struct Columns {
  float e1[TT > 0 ? TT : 1];
  float e2[TT > 0 ? TT : 1];
  float b1, b2;

  __device__ __forceinline__ void set(const Voxel<TT>& v, float nb1, float nb2, const float* n1,
                                      const float* n2) {
    b1 = nb1;
    b2 = nb2;
    if constexpr (TT > 0) {
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        e1[t] = n1[t];
        e2[t] = n2[t];
      }
    }
  }
  __device__ __forceinline__ float E1(const Voxel<TT>& v, int t) const {
    if constexpr (TT > 0) return e1[t]; else return expf(b1 * v.X(t));
  }
  __device__ __forceinline__ float E2(const Voxel<TT>& v, int t) const {
    if constexpr (TT > 0) return e2[t]; else return expf(b2 * v.X(t));
  }
};

// Model value and cost at (a1, b1, a2, b2); fills the proposal's columns
// when TT > 0.
template <int TT>
__device__ __forceinline__ float cost_at(const Voxel<TT>& v, int T, float a1, float b1, float a2,
                                         float b2, float* n1, float* n2) {
  float c = -0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
    const float xt = v.X(t);
    const float e1 = expf(b1 * xt);
    const float e2 = expf(b2 * xt);
    if constexpr (TT > 0) {
      n1[t] = e1;
      n2[t] = e2;
    }
    const float r = a1 * e1 + a2 * e2 - v.Y(t);
    c += r * r;
  }
  return isfinite(c) ? c : INFINITY;
}

template <int TT>
__global__ void __launch_bounds__(dosma::kThreads)
biexp_lm_kernel(const float* __restrict__ x, const float* __restrict__ y, long long y_st,
                long long y_sn, const float* __restrict__ p0, long long p0_sp, long long p0_sn,
                float* __restrict__ out, long long N, int T_rt, int max_iter, float ftol,
                float xtol) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= N) return;

  const Voxel<TT> v(x, y + n * y_sn, y_st, T_rt);
  const int T = TT > 0 ? TT : T_rt;
  constexpr int R = TT > 0 ? TT : 1;

  const float* pv = p0 + n * p0_sn;
  float a1 = __ldg(pv), b1 = __ldg(pv + p0_sp), a2 = __ldg(pv + 2 * p0_sp),
        b2 = __ldg(pv + 3 * p0_sp);

  Columns<TT> cols;
  float n1[R], n2[R];
  float cost = cost_at<TT>(v, T, a1, b1, a2, b2, n1, n2);
  cols.set(v, b1, b2, n1, n2);
  const bool bad_init = !isfinite(cost);  // cost_at maps it to +inf

  float lam = 1e-3f;
  bool latched = false;
  for (int it = 0; it < max_iter && !latched; ++it) {
    // Normal equations (lower triangle) and gradient, summed over echoes.
    float A11 = -0.0f, A21 = -0.0f, A22 = -0.0f, A31 = -0.0f, A32 = -0.0f, A33 = -0.0f,
          A41 = -0.0f, A42 = -0.0f, A43 = -0.0f, A44 = -0.0f;
    float g1 = -0.0f, g2 = -0.0f, g3 = -0.0f, g4 = -0.0f;
#pragma unroll
    for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
      const float xt = v.X(t);
      const float e1 = cols.E1(v, t);
      const float e2 = cols.E2(v, t);
      const float r = a1 * e1 + a2 * e2 - v.Y(t);
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
    const float new_cost = cost_at<TT>(v, T, na1, nb1, na2, nb2, n1, n2);

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
      cols.set(v, nb1, nb2, n1, n2);
      cost = new_cost;
    }
    lam = accept ? nmax(lam * 0.33f, 1e-12f) : nmin(lam * 10.0f, 1e10f);
  }

  float ysum = -0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) ysum += v.Y(t);
  const float y_mean = ysum / (float)T;
  float ss_res = -0.0f, ss_tot = -0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
    const float r = a1 * cols.E1(v, t) + a2 * cols.E2(v, t) - v.Y(t);
    ss_res += r * r;
    const float d = v.Y(t) - y_mean;
    ss_tot += d * d;
  }
  const bool finite = isfinite(a1) && isfinite(b1) && isfinite(a2) && isfinite(b2);

  out[n] = a1;
  out[N + n] = b1;
  out[2 * N + n] = a2;
  out[3 * N + n] = b2;
  out[4 * N + n] = 1.0f - ss_res / (ss_tot + 1e-8f);
  out[5 * N + n] = (latched && finite && !bad_init) ? 1.0f : 0.0f;
}

template <int TT>
void launch(const float* x, const float* y, long long y_st, long long y_sn, const float* p0,
            long long p0_sp, long long p0_sn, float* out, long long N, int T, int max_iter,
            float ftol, float xtol, cudaStream_t stream) {
  const long long blocks = (N + dosma::kThreads - 1) / dosma::kThreads;
  biexp_lm_kernel<TT><<<(unsigned int)blocks, dosma::kThreads, 0, stream>>>(
      x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol);
}

}  // namespace

// x (T,) f32; y (T, N) f32 read at y[t * y_st + n * y_sn]; p0 the seeds
// [a1, b1, a2, b2] read at p0[i * p0_sp + n * p0_sn] (p0_sn = 0 broadcasts
// one seed); out (6, N) f32 contiguous, rows [a1, b1, a2, b2, r2,
// converged]. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int dosma_biexp_lm(const float* x, const float* y, long long y_st, long long y_sn,
                              const float* p0, long long p0_sp, long long p0_sn, float* out,
                              long long N, int T, int max_iter, float ftol, float xtol,
                              void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if ((N + dosma::kThreads - 1) / dosma::kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 1: launch<1>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, s); break;
    case 2: launch<2>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, s); break;
    case 3: launch<3>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, s); break;
    case 4: launch<4>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, s); break;
    case 5: launch<5>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, s); break;
    case 6: launch<6>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, s); break;
    case 7: launch<7>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, s); break;
    case 8: launch<8>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, s); break;
    default: launch<0>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, s);
  }
  return (int)cudaGetLastError();
}
