// Per-voxel monoexponential fit y = a * exp(b * x): optional log-linear
// seed, then VARPRO Levenberg-Marquardt on the rate b.
//
// Replaces dosma_tpu/ops/monoexp_pallas.py::_kernel (with _seed_polyfit).
// The plain PyTorch version of the same algorithm, which the tests and the
// chip smoke test hold this kernel against, is
// dosma_tpu_torch/ops/monoexp.py::_packed_reference.
//
// What bounds it on an H100: instructions issued. A voxel costs T*4 bytes
// of echoes in and 16 bytes of packed results out (32 bytes at T = 4):
// 537 MB at 16.7M voxels, 0.16 ms at 3.35 TB/s. Against that, with every
// multiply and add its own instruction (-fmad=false, below), an LM
// iteration is ~230 SASS instructions (T = 4, uniform echoes) and the
// seed, first evaluation and results ~400 more, and a warp iterates as
// long as its slowest voxel (1.5x the mean iteration count on noisy
// relaxometry data). Measured on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit: 0.74 ms at 16.7M voxels x 4 echoes (chip_smoke.py phase 4,
// tools/compare_kernels.py), near the card's issue rate for that count.
// The design spends as few instructions as the plain version's operations
// allow:
//   - one evaluation a point (evaluate()): the exponential columns at a rate
//     are built once and give every sum, both amplitudes and both costs
//     the loop reads. It runs at the seed and at each proposal; an accepted
//     proposal's evaluation is carried into the next iteration, and the
//     final one gives a and r^2's residual sum, so the tail computes only
//     ss_tot;
//   - for T <= 8 the kernel is instantiated per T and the voxel's echoes,
//     x, the per-voxel products x*y and x^2*y and the columns live in
//     registers; any other T re-reads y from global memory (L1/L2 resident
//     after the first pass) and rebuilds the columns for each pass;
//   - uniformly spaced echoes use e_t = e0 * q^t: two expf per evaluation
//     instead of T; the seed takes one logf per echo;
//   - one thread per voxel; the voxel axis of y (T, N) is contiguous, so
//     each echo row is read coalesced across a warp, and the four output
//     rows of (4, N) are written coalesced; the ragged edge is masked in
//     the kernel, so no pad voxels exist.
// Lane refill (generic_lm.cuh) does not pay here: the seed, the first
// evaluation and the results are ~40% of a voxel's instructions, and a
// refilled lane runs them while its warp waits. Moving a block's unfinished
// voxels into full warps through shared memory, at a barrier after every
// iteration, was measured slower (1.02 ms, and 0.81 ms with registers
// capped for five blocks an SM): the barriers and the lost occupancy cost
// more than the divergence they removed.
// Each thread iterates until its own voxel latches or max_iter, and a
// latched voxel is frozen: its result does not depend on its neighbours.
// (The TPU kernel packed 8192 voxels per block, kept polishing latched
// lanes until the whole block latched, and exited per block.)
//
// Semantics kept from the TPU kernel: every clamp (1e-30 on sums and
// curvature, 1e-12 on lambda and |b|, 1e10 on lambda, max(1e-3 * peak,
// 1e-10) in the seed); the cost taken from the actual residuals; voxels
// whose initial cost is not finite latch at init; converged = latched *
// finite * (1 - bad_init); r2 = 1 - ss_res / (ss_tot + 1e-8). The TPU
// kernel's 1e-38 clamp guards a cached ratio e1/e0 that only its uniform
// path reads; here the uniform path computes q = exp(b dx) directly (as the
// TPU kernel did there) and the non-uniform path caches nothing.
// Maxima propagate NaN, as jnp.maximum and torch.maximum do.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false (ops/_build.py). No --use_fast_math: expf, logf and the
// divisions are the accurate versions. -fmad=false keeps every multiply
// and add separately rounded, as the plain version's torch ops are; with
// the sums over echoes taken in the same order on both sides, the kernel
// and the plain version round alike. Without it, ulp-level differences
// move the ftol latch by an iteration on noisy voxels, and the two stop
// up to ~5e-5 apart (measured on the H100, 4% of noisy voxels beyond 1e-5).
// The price: the kernel takes 29% more time than a build with fused
// multiply-adds (0.75 vs 0.58 ms at 16.7M voxels on an NVIDIA H100 80GB
// HBM3 at a 700 W power limit; tools/compare_kernels.py --fma measures
// both, and counts the FMA build's values beyond the tolerance).

#include "lm_common.cuh"

namespace {

using dosma::nmax;
using dosma::nmin;
using dosma::Voxel;

// The exponential columns e_t = exp(b x_t) at one rate, produced in order
// t = 0, 1, ..., T-1 by at(). Uniform echoes (UNI) multiply by
// q = exp(b dx), exactly as the TPU kernel's exp_cols did.
template <bool UNI>
struct ECols {
  float b, e0, q, cur;
  __device__ __forceinline__ ECols(float b_, float x0, float dx) : b(b_), e0(0.f), q(0.f), cur(0.f) {
    if constexpr (UNI) {
      e0 = expf(b * x0);
      q = expf(b * dx);
    }
  }
  __device__ __forceinline__ float at(int t, float xt) {
    if constexpr (UNI) {
      cur = (t == 0) ? e0 : cur * q;
      return cur;
    } else {
      return expf(b * xt);
    }
  }
};

// One voxel's echoes with the per-voxel products x*y and x^2*y that the
// sums read, hoisted out of the LM loop (T <= 8: in registers).
template <int TT>
struct Echoes {
  Voxel<TT> v;
  float xy[TT > 0 ? TT : 1];
  float xxy[TT > 0 ? TT : 1];
  __device__ __forceinline__ Echoes(const float* x, const float* y, long long stride, int t_rt)
      : v(x, y, stride, t_rt) {
    if constexpr (TT > 0) {
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const float xt = v.X(t), yt = v.Y(t);
        xy[t] = xt * yt;
        xxy[t] = (xt * xt) * yt;
      }
    }
  }
  __device__ __forceinline__ float XY(int t) const {
    if constexpr (TT > 0) return xy[t]; else return v.X(t) * v.Y(t);
  }
  __device__ __forceinline__ float XXY(int t) const {
    if constexpr (TT > 0) return xxy[t]; else return (v.X(t) * v.X(t)) * v.Y(t);
  }
};

// What one evaluation at a rate b gives, carried from an accepted proposal
// to the next iteration: the six sums of the Newton step (s1 clamped at
// 1e-30), 1/s1, the cost at the amplitude u * (1/s1) (non-finite mapped to
// +inf: the loop's cost), and the reduced cost phi(b) = min_a sum (a e -
// y)^2 at the amplitude t1/s1 (t1 = u), raw: mapped, it is the accept
// test's cost; raw, it is r^2's residual sum.
struct Eval {
  float s1, s2, s3, u, u1, u2, inv_s1, cost, phi;
};

// Builds the columns at b once (T <= 8: kept in registers; otherwise
// rebuilt for each pass) and returns every quantity above, each computed
// with the operations, operands and order of the plain version
// (ops/monoexp.py::_packed_reference): its sums pass, its cost pass and
// its _reduced_cost.
template <int TT, bool UNI>
__device__ __forceinline__ Eval evaluate(const Echoes<TT>& h, int T, float b, float x0, float dx) {
  const Voxel<TT>& v = h.v;
  float cols[TT > 0 ? TT : 1];
  Eval r;
  float s1 = 0.f, s2 = 0.f, s3 = 0.f, u = 0.f, u1 = 0.f, u2 = 0.f;
  {
    ECols<UNI> ec(b, x0, dx);
#pragma unroll
    for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
      const float xt = v.X(t);
      const float e = ec.at(t, xt);
      if constexpr (TT > 0) cols[t] = e;
      const float e2 = e * e;
      s1 += e2;
      s2 += xt * e2;
      s3 += (xt * xt) * e2;
      u += v.Y(t) * e;
      u1 += h.XY(t) * e;
      u2 += h.XXY(t) * e;
    }
  }
  s1 = nmax(s1, 1e-30f);
  const float inv_s1 = 1.0f / s1;
  const float am = u * inv_s1;  // the loop's amplitude
  const float ad = u / s1;      // _reduced_cost's amplitude t1 / s1
  float cost = 0.f, phi = 0.f;
  auto residuals = [&](int t, float e) {
    const float rm = am * e - v.Y(t);
    cost += rm * rm;
    const float rd = ad * e - v.Y(t);
    phi += rd * rd;
  };
  if constexpr (TT > 0) {
#pragma unroll
    for (int t = 0; t < TT; ++t) residuals(t, cols[t]);
  } else {
    ECols<UNI> ec(b, x0, dx);
    for (int t = 0; t < T; ++t) residuals(t, ec.at(t, v.X(t)));
  }
  r.s1 = s1;
  r.s2 = s2;
  r.s3 = s3;
  r.u = u;
  r.u1 = u1;
  r.u2 = u2;
  r.inv_s1 = inv_s1;
  r.cost = isfinite(cost) ? cost : INFINITY;
  r.phi = phi;
  return r;
}

// Threads a block, and the fewest blocks an SM must hold at once, which caps
// the registers a thread may use (ptxas's report: chip_smoke.py phase 4).
constexpr int kThreads = 256;
constexpr int kMinBlocks = 1;

template <int TT, bool UNI>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
monoexp_lm_kernel(const float* __restrict__ x, const float* __restrict__ y, long long y_st,
                  long long y_sn, const float* __restrict__ p0b, long long p0_sn,
                  float* __restrict__ out, long long N, int T_rt, int max_iter, float ftol,
                  float xtol, int seed_in_kernel) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= N) return;

  const Echoes<TT> h(x, y + n * y_sn, y_st, T_rt);
  const Voxel<TT>& v = h.v;
  const int T = TT > 0 ? TT : T_rt;
  const float x0 = v.X(0);
  const float dx = T > 1 ? v.X(1) - v.X(0) : v.X(0);

  float b;
  if (seed_in_kernel) {
    // Log-linear seed: deg-1 least squares on log(y), each voxel clamped
    // to a floor relative to its own peak; one logf per echo (T <= 8).
    float peak = v.Y(0);
#pragma unroll
    for (int t = 1; t < (TT > 0 ? TT : T); ++t) peak = nmax(peak, v.Y(t));
    const float floor_ = nmax(1e-3f * peak, 1e-10f);
    float xsum = 0.f;
#pragma unroll
    for (int t = 0; t < (TT > 0 ? TT : T); ++t) xsum += v.X(t);
    const float xm = xsum / (float)T;
    float logs[TT > 0 ? TT : 1];
    float varx = 0.f, Lsum = 0.f;
#pragma unroll
    for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
      const float xc = v.X(t) - xm;
      varx += xc * xc;
      const float L = logf(nmax(v.Y(t), floor_));
      if constexpr (TT > 0) logs[t] = L;
      Lsum += L;
    }
    const float Lm = Lsum / (float)T;
    float num = 0.f;
#pragma unroll
    for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
      float L;
      if constexpr (TT > 0) L = logs[t]; else L = logf(nmax(v.Y(t), floor_));
      num += (v.X(t) - xm) * (L - Lm);
    }
    b = num / varx;
  } else {
    // Only the rate seeds the loop: under VARPRO the amplitude is
    // closed-form at every iterate.
    b = __ldg(p0b + n * p0_sn);
  }

  // One evaluation a point: at the seed, then at each proposal; an accepted
  // proposal's evaluation is the next iteration's sums and cost.
  Eval cur = evaluate<TT, UNI>(h, T, b, x0, dx);
  const bool bad_init = !(isfinite(cur.phi) && isfinite(cur.u));

  float lam = 1e-3f;
  bool latched = bad_init;
  for (int it = 0; it < max_iter && !latched; ++it) {
    const float a = cur.u * cur.inv_s1;
    const float cost = cur.cost;
    const float s2 = cur.s2, u1 = cur.u1;

    // phi'/2 and phi'' of the reduced cost; |phi''| keeps a descent
    // direction in locally concave regions.
    const float g = a * (a * s2 - u1);
    const float phi2 = 4.0f * a * a * cur.s3 +
                       (8.0f * a * s2 * (u1 - a * s2) - 2.0f * (u1 * u1 + cur.u * cur.u2)) *
                           cur.inv_s1;
    const float D = nmax(0.5f * fabsf(phi2), 1e-30f);
    const float raw = g / D;  // undamped Newton step
    const float db = raw / (1.0f + lam);
    const float new_b = b - db;
    const Eval prop = evaluate<TT, UNI>(h, T, new_b, x0, dx);
    const float new_cost = isfinite(prop.phi) ? prop.phi : INFINITY;

    // Equal cost is accepted: at the optimum the proposal reproduces b.
    const bool accept = (new_cost <= cost) && isfinite(new_cost);
    const bool rel_decrease = (cost - new_cost) <= ftol * nmax(cost, 1e-30f);
    const bool small_step = fabsf(raw) <= xtol * nmax(fabsf(b), 1e-12f);
    const bool pred_small = (D * raw * raw) <= ftol * nmax(cost, 1e-30f);
    const bool at_floor = (!accept) && (lam >= 1e2f);
    latched = (accept && rel_decrease) || small_step || pred_small || at_floor;

    if (accept) {
      b = new_b;
      cur = prop;
    }
    lam = accept ? nmax(lam * 0.33f, 1e-12f) : nmin(lam * 10.0f, 1e10f);
  }

  // The closed-form amplitude at the final rate, and r^2 from the residual
  // sum carried with it; only ss_tot is left to compute.
  const float a = cur.u / cur.s1;
  float ysum = 0.f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) ysum += v.Y(t);
  const float y_mean = ysum / (float)T;
  float ss_tot = 0.f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
    const float d = v.Y(t) - y_mean;
    ss_tot += d * d;
  }
  const bool finite = isfinite(a) && isfinite(b);
  const float converged = (latched && finite && !bad_init) ? 1.0f : 0.0f;

  out[n] = a;
  out[N + n] = b;
  out[2 * N + n] = 1.0f - cur.phi / (ss_tot + 1e-8f);
  out[3 * N + n] = converged;
}

template <int TT, bool UNI>
void launch(const float* x, const float* y, long long y_st, long long y_sn, const float* p0b,
            long long p0_sn, float* out, long long N, int T, int max_iter, float ftol, float xtol,
            int seed_in_kernel, cudaStream_t stream) {
  const long long blocks = (N + kThreads - 1) / kThreads;
  monoexp_lm_kernel<TT, UNI><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      x, y, y_st, y_sn, p0b, p0_sn, out, N, T, max_iter, ftol, xtol, seed_in_kernel);
}

template <bool UNI>
void dispatch_T(const float* x, const float* y, long long y_st, long long y_sn, const float* p0b,
                long long p0_sn, float* out, long long N, int T, int max_iter, float ftol,
                float xtol, int seed_in_kernel, cudaStream_t s) {
#define DOSMA_MONOEXP_CASE(TV)                                                              \
  case TV:                                                                                  \
    launch<TV, UNI>(x, y, y_st, y_sn, p0b, p0_sn, out, N, T, max_iter, ftol, xtol,          \
                    seed_in_kernel, s);                                                     \
    break;
  switch (T) {
    DOSMA_MONOEXP_CASE(1)
    DOSMA_MONOEXP_CASE(2)
    DOSMA_MONOEXP_CASE(3)
    DOSMA_MONOEXP_CASE(4)
    DOSMA_MONOEXP_CASE(5)
    DOSMA_MONOEXP_CASE(6)
    DOSMA_MONOEXP_CASE(7)
    DOSMA_MONOEXP_CASE(8)
    default:
      launch<0, UNI>(x, y, y_st, y_sn, p0b, p0_sn, out, N, T, max_iter, ftol, xtol,
                     seed_in_kernel, s);
  }
#undef DOSMA_MONOEXP_CASE
}

}  // namespace

// x (T,) f32; y (T, N) f32 read at y[t * y_st + n * y_sn]; p0b the rate
// seeds read at p0b[n * p0_sn] (p0_sn = 0 broadcasts one seed; unused when
// seed_in_kernel != 0); out (4, N) f32 contiguous, rows [a, b, r2,
// converged]. uniform_x != 0 (only for T > 2) takes the e0 * q^t path.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int dosma_monoexp_lm(const float* x, const float* y, long long y_st, long long y_sn,
                                const float* p0b, long long p0_sn, float* out, long long N, int T,
                                int max_iter, float ftol, float xtol, int seed_in_kernel,
                                int uniform_x, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if ((N + kThreads - 1) / kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uniform_x && T > 2)
    dispatch_T<true>(x, y, y_st, y_sn, p0b, p0_sn, out, N, T, max_iter, ftol, xtol,
                     seed_in_kernel, s);
  else
    dispatch_T<false>(x, y, y_st, y_sn, p0b, p0_sn, out, N, T, max_iter, ftol, xtol,
                      seed_in_kernel, s);
  return (int)cudaGetLastError();
}
