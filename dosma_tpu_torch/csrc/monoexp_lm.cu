// Per-voxel monoexponential fit y = a * exp(b * x): optional log-linear
// seed, then VARPRO Levenberg-Marquardt on the rate b.
//
// Replaces dosma_tpu/ops/monoexp_pallas.py::_kernel (with _seed_polyfit).
// The plain PyTorch version of the same algorithm, which the tests and the
// chip smoke test hold this kernel against, is
// dosma_tpu_torch/ops/monoexp.py::_packed_reference.
//
// Two entries share one LM body (fit_voxel):
//   - dosma_monoexp_lm: the parameters, packed (4, N) rows [a, b, r2,
//     converged] (sharded_lm_fit, curve_fit);
//   - dosma_monoexp_maps: MonoExponentialFit's finished maps. It reads the
//     T echo rows where they lie (T <= 8: one pointer a row, no stacked
//     copy) and writes tc (N,) and r2 (N,) after the epilogue that
//     ops/monoexp.py::maps_epilogue computes in torch, in its order: the
//     NaN policy, 1/|b|, bounds, the r^2 threshold, the mask, nan_to_num
//     and rounding.
//
// What bounds it on an H100: instructions issued. A voxel costs T*4 bytes
// of echoes in and 16 bytes of packed results out (32 bytes at T = 4):
// 537 MB at 16.7M voxels, 0.16 ms at 3.35 TB/s; the maps entry writes 8
// bytes a voxel (24 at T = 4) and reads 4 more of mask when given one.
// Against that, with every multiply and add its own instruction
// (-fmad=false, below), an LM
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
//   - one thread per voxel; the voxel axis of each echo row is contiguous,
//     so each row is read coalesced across a warp, and the output rows are
//     written coalesced; the ragged edge is masked in the kernel, so no pad
//     voxels exist.
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
// HBM3 at a 700 W power limit, measured when the port could still build
// both; it has one build now).

#include <cfloat>

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
  __device__ __forceinline__ explicit Echoes(const Voxel<TT>& v_) : v(v_) {
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
// The maps entry needs a register or two more than the packed one for its
// epilogue; uncapped (65 registers at T = 4) an SM holds 3 blocks, not 4,
// and the kernel took 0.87 ms at config1 against 0.73 for the packed one.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, 16.7M voxels, ms at
// kMapsMinBlocks 1 / 4 / 5 / 6: T = 4 uniform 0.893 / 0.812 / 0.789 / 0.814,
// T = 4 not uniform 1.023 / 1.034 / 1.006 / 1.044, T = 7 uniform 1.887 /
// 1.413 / 1.447 / 1.514, T = 8 not uniform 1.994 / 1.693 / 1.758 / 1.863
// (5 blocks spill 76 bytes at T = 4; 4 blocks 40-76 bytes at T = 7-8).
constexpr int kThreads = 256;
constexpr int kMinBlocks = 1;
constexpr int kMapsMinBlocks = 5;      // T <= 4
constexpr int kMapsMinBlocksWide = 4;  // T > 4

// One voxel's fit: its amplitude a, rate b, r^2 and convergence flag.
struct Result {
  float a, b, r2;
  bool converged;
};

// The LM body both entries run for voxel n: the seed (log-linear in the
// kernel, or the rate p0b[n * p0_sn]), the loop until the voxel latches or
// max_iter, then a and r^2 at the final rate.
template <int TT, bool UNI>
__device__ __forceinline__ Result fit_voxel(const Echoes<TT>& h, int T,
                                            const float* __restrict__ p0b, long long p0_sn,
                                            long long n, int max_iter, float ftol, float xtol,
                                            int seed_in_kernel) {
  const Voxel<TT>& v = h.v;
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
  Result res;
  res.a = a;
  res.b = b;
  res.r2 = 1.0f - cur.phi / (ss_tot + 1e-8f);
  res.converged = latched && finite && !bad_init;
  return res;
}

template <int TT, bool UNI>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
monoexp_lm_kernel(const float* __restrict__ x, const float* __restrict__ y, long long y_st,
                  long long y_sn, const float* __restrict__ p0b, long long p0_sn,
                  float* __restrict__ out, long long N, int T_rt, int max_iter, float ftol,
                  float xtol, int seed_in_kernel) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= N) return;

  const Echoes<TT> h(Voxel<TT>(x, y + n * y_sn, y_st, T_rt));
  const Result r = fit_voxel<TT, UNI>(h, TT > 0 ? TT : T_rt, p0b, p0_sn, n, max_iter, ftol,
                                      xtol, seed_in_kernel);
  out[n] = r.a;
  out[N + n] = r.b;
  out[2 * N + n] = r.r2;
  out[3 * N + n] = r.converged ? 1.0f : 0.0f;
}

// Where the maps entry reads the echoes: T <= kMaxRegisterEchoes, row t at
// y[t] (voxel n at y[t][n * sn]); otherwise one (T, N) buffer at y[0]
// (echo t of voxel n at y[0][t * st + n * sn]).
struct EchoRows {
  const float* y[dosma::kMaxRegisterEchoes];
  long long st, sn;
};

// The maps' epilogue: bounds (lb, ub) on tc, the r^2 threshold when
// has_thr, nan_fill, and rounding (round 1: nearbyint(tc * scale) / scale,
// -1: nearbyint(tc / scale) * scale, scale = 10^|decimals|, as torch.round
// computes it; 0: none).
struct Epilogue {
  float lb, ub, thr, nan_fill, scale;
  int has_thr, round;
};

struct MapsArgs {
  const float* x;
  EchoRows rows;
  const float* p0b;
  long long p0_sn;
  const float* mask;  // (N,) float32, or null
  float* tc;
  float* r2;
  long long N;
  int T, max_iter;
  float ftol, xtol;
  int seed_in_kernel;
  Epilogue ep;
};

template <int TT>
__device__ __forceinline__ Voxel<TT> row_voxel(const float* x, const EchoRows& rows,
                                               long long n, int T) {
  if constexpr (TT > 0) {
    Voxel<TT> v;
    v.xg = x;
    v.yg = nullptr;
    v.st = 0;
    v.T = TT;
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      v.xs[t] = __ldg(x + t);
      v.ys[t] = __ldg(rows.y[t] + n * rows.sn);
    }
    return v;
  } else {
    return Voxel<0>(x, rows.y[0] + n * rows.sn, rows.st, T);
  }
}

// The fit of voxel n, then in registers what ops/monoexp.py::_nan_policy
// and maps_epilogue compute in torch, operation for operation.
template <int TT, bool UNI>
__global__ void __launch_bounds__(kThreads, (TT > 0 && TT <= 4) ? kMapsMinBlocks
                                                                  : kMapsMinBlocksWide)
monoexp_lm_maps_kernel(const MapsArgs a) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= a.N) return;

  const int T = TT > 0 ? TT : a.T;
  const Echoes<TT> h(row_voxel<TT>(a.x, a.rows, n, T));
  const Result r = fit_voxel<TT, UNI>(h, T, a.p0b, a.p0_sn, n, a.max_iter, a.ftol, a.xtol,
                                      a.seed_in_kernel);

  // nan_policy "scipy": an all-zero voxel or a voxel that did not converge
  // gives b NaN and r^2 0.
  bool all_zero = true;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) all_zero = all_zero && (h.v.Y(t) == 0.f);
  const bool bad = all_zero || !r.converged;
  const float b = bad ? NAN : r.b;
  float r2 = bad ? 0.f : r.r2;

  const Epilogue& ep = a.ep;
  float tc = 1.0f / fabsf(b);
  if (tc < ep.lb || tc > ep.ub) tc = NAN;
  if (ep.has_thr && r2 < ep.thr) tc = NAN;
  if (a.mask != nullptr && !(__ldg(a.mask + n) > 0.f)) {
    tc = NAN;
    r2 = ep.nan_fill;
  }
  // nan_to_num: NaN to nan_fill, +-inf to +-FLT_MAX.
  tc = isnan(tc) ? ep.nan_fill : (tc == INFINITY ? FLT_MAX : (tc == -INFINITY ? -FLT_MAX : tc));
  if (ep.round > 0)
    tc = nearbyintf(tc * ep.scale) / ep.scale;
  else if (ep.round < 0)
    tc = nearbyintf(tc / ep.scale) * ep.scale;
  a.tc[n] = tc;
  a.r2[n] = r2;
}

struct PackedArgs {
  const float *x, *y;
  long long y_st, y_sn;
  const float* p0b;
  long long p0_sn;
  float* out;
  long long N;
  int T, max_iter;
  float ftol, xtol;
  int seed_in_kernel;
};

template <int TT, bool UNI>
struct Packed {
  static void run(const PackedArgs& a, unsigned int blocks, cudaStream_t s) {
    monoexp_lm_kernel<TT, UNI><<<blocks, kThreads, 0, s>>>(a.x, a.y, a.y_st, a.y_sn, a.p0b,
                                                           a.p0_sn, a.out, a.N, a.T, a.max_iter,
                                                           a.ftol, a.xtol, a.seed_in_kernel);
  }
};

template <int TT, bool UNI>
struct Maps {
  static void run(const MapsArgs& a, unsigned int blocks, cudaStream_t s) {
    monoexp_lm_maps_kernel<TT, UNI><<<blocks, kThreads, 0, s>>>(a);
  }
};

// Launches kernel K's instantiation for T (T <= 8: its own; otherwise TT =
// 0) and the echo spacing; uniform (e0 * q^t) only for T > 2.
template <template <int, bool> class K, bool UNI, class Args>
void dispatch_T(const Args& a, unsigned int blocks, cudaStream_t s) {
  switch (a.T) {
    case 1: K<1, UNI>::run(a, blocks, s); break;
    case 2: K<2, UNI>::run(a, blocks, s); break;
    case 3: K<3, UNI>::run(a, blocks, s); break;
    case 4: K<4, UNI>::run(a, blocks, s); break;
    case 5: K<5, UNI>::run(a, blocks, s); break;
    case 6: K<6, UNI>::run(a, blocks, s); break;
    case 7: K<7, UNI>::run(a, blocks, s); break;
    case 8: K<8, UNI>::run(a, blocks, s); break;
    default: K<0, UNI>::run(a, blocks, s);
  }
}

template <template <int, bool> class K, class Args>
int launch(const Args& a, int uniform_x, void* stream) {
  if (a.N <= 0 || a.T <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (a.N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uniform_x && a.T > 2)
    dispatch_T<K, true>(a, (unsigned int)blocks, s);
  else
    dispatch_T<K, false>(a, (unsigned int)blocks, s);
  return (int)cudaGetLastError();
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
  const PackedArgs a{x, y, y_st, y_sn, p0b, p0_sn, out, N, T, max_iter, ftol, xtol,
                     seed_in_kernel};
  return launch<Packed>(a, uniform_x, stream);
}

// The same fit, and the finished maps: tc (N,) and r2 (N,) f32 contiguous.
// y_rows: for T <= 8, T pointers, echo t of voxel n at y_rows[t][n * y_sn];
// otherwise one pointer, echo t of voxel n at y_rows[0][t * y_st + n * y_sn].
// tc of a voxel outside (lb, ub), or with r2 < thr when has_thr, is NaN.
// mask (N,) f32 or null: where it is not > 0, tc is NaN and r2 nan_fill.
// Then tc's NaNs become nan_fill and it is rounded (round_mode 1 / -1 / 0
// and round_scale as in Epilogue). Launches on `stream`, does not synchronise,
// and returns cudaGetLastError().
extern "C" int dosma_monoexp_maps(const float* x, const float* const* y_rows, long long y_st,
                                  long long y_sn, const float* p0b, long long p0_sn,
                                  const float* mask, float* tc, float* r2, long long N, int T,
                                  int max_iter, float ftol, float xtol, int seed_in_kernel,
                                  int uniform_x, float lb, float ub, int has_thr, float thr,
                                  float nan_fill, int round_mode, float round_scale,
                                  void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  MapsArgs a{};
  a.x = x;
  const int rows = T <= dosma::kMaxRegisterEchoes ? T : 1;
  for (int t = 0; t < rows; ++t) a.rows.y[t] = y_rows[t];
  a.rows.st = y_st;
  a.rows.sn = y_sn;
  a.p0b = p0b;
  a.p0_sn = p0_sn;
  a.mask = mask;
  a.tc = tc;
  a.r2 = r2;
  a.N = N;
  a.T = T;
  a.max_iter = max_iter;
  a.ftol = ftol;
  a.xtol = xtol;
  a.seed_in_kernel = seed_in_kernel;
  a.ep = Epilogue{lb, ub, thr, nan_fill, round_scale, has_thr, round_mode};
  return launch<Maps>(a, uniform_x, stream);
}
