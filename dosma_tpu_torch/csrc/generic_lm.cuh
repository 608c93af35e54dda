// Per-voxel Levenberg-Marquardt for a small model (P <= 4 parameters) that
// is given as code: the template of the generic fit kernel.
//
// Replaces dosma_tpu/ops/generic_lm_pallas.py::_kernel. There the model is
// traced inside the Pallas kernel and its Jacobian columns come from P
// forward-mode jax.jvp passes. Here dosma_tpu_torch/ops/generic_lm.py
// traces the user's torch model with torch.fx, checks every node against a
// small whitelist, and emits a `Model` struct whose
// `template <class V> static V eval(float x, const V* p)` evaluates the
// model either on floats (the cost of a proposal) or on the dual numbers
// below (the value and all P Jacobian columns in one pass: the counterpart
// of the P one-hot jvp passes). That generated source includes this header
// and is compiled once per model (ops/_build.py::load_generated). The plain
// PyTorch version, which the tests and the chip smoke test hold the kernel
// against, is ops/generic_lm.py::generic_lm_reference: the same LM loop as
// ops/nlls.py::lm_fit, fed by a torch interpreter of the same dual-number
// program, so the two compute every value and derivative with the same
// operations.
//
// What bounds it on an H100: a voxel costs T*4 bytes of data and P*4 bytes
// of seeds in, (P+2)*4 bytes out (40 bytes at T = 5, P = 3), against one
// dual evaluation (P+1 values per model operation), P(P+1)/2 + P sums and a
// PxP Cholesky per echo and iteration: issue-bound, like the other fits
// (measured: 1.22-1.24 ms for a * exp(b x) + c on 4.19M voxels x 5
// points, on an H100 80GB HBM3 at a 700 W power limit; chip_smoke.py
// phase 6).
// The design, as in monoexp_lm.cu and biexp_lm.cu: one thread per voxel,
// echo rows read coalesced along the contiguous voxel axis, echoes in
// registers for T <= 8 (one instantiation per T), the ragged edge masked
// (the TPU kernel padded with the model evaluated at the pad seed), and
// each voxel frozen at its own latch (the TPU kernel kept polishing latched
// lanes until its block had latched).
//
// Semantics kept from the TPU kernel: cost from the residuals with
// non-finite costs mapped to +inf; a voxel whose initial cost is not finite
// latches at once; damping d + lam * max(d, 1e-12) on the diagonal; the
// unrolled Cholesky of ops/nlls.py::_chol_solve_unrolled with pivots
// clamped at 1e-30; strict accept new_cost < cost; latches on an accepted
// step with relative decrease <= ftol or largest step ratio <= xtol, on a
// small step at lam <= 1e-2 (gn_small), and on a rejection at lam >= 1e2
// (at_floor); lam * 0.33 (floor 1e-12) on accept, * 3 (cap 1e10) on
// reject; converged = latched * finite * (1 - bad_init);
// r2 = 1 - ss_res / (ss_tot + 1e-8). Maxima propagate NaN.
//
// Built with -fmad=false and ordered sums over echoes, like the other fits.
#pragma once

#include "lm_common.cuh"

namespace dosma {

// A value and its derivatives with respect to the P parameters.
template <int P>
struct Dual {
  float v;
  float d[P];
};

// ---- The whitelisted operations, on floats and on dual numbers. Each
// ---- dual operation computes its value exactly as the float one does.
__device__ __forceinline__ float cpow(float a, float c) {
  if (c == 1.0f) return a;
  if (c == 2.0f) return a * a;
  if (c == 3.0f) return a * a * a;
  if (c == 0.5f) return sqrtf(a);
  if (c == -1.0f) return 1.0f / a;
  return powf(a, c);
}

__device__ __forceinline__ float op_add(float a, float b) { return a + b; }
__device__ __forceinline__ float op_sub(float a, float b) { return a - b; }
__device__ __forceinline__ float op_mul(float a, float b) { return a * b; }
__device__ __forceinline__ float op_div(float a, float b) { return a / b; }
__device__ __forceinline__ float op_neg(float a) { return -a; }
__device__ __forceinline__ float op_exp(float a) { return expf(a); }
__device__ __forceinline__ float op_log(float a) { return logf(a); }
__device__ __forceinline__ float op_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ float op_abs(float a) { return fabsf(a); }
__device__ __forceinline__ float op_sin(float a) { return sinf(a); }
__device__ __forceinline__ float op_cos(float a) { return cosf(a); }
__device__ __forceinline__ float op_tanh(float a) { return tanhf(a); }
__device__ __forceinline__ float op_pow(float a, float c) { return cpow(a, c); }

#define DOSMA_DUAL_LOOP(expr) \
  _Pragma("unroll") for (int i = 0; i < P; ++i) r.d[i] = (expr)

template <int P>
__device__ __forceinline__ Dual<P> op_add(const Dual<P>& a, const Dual<P>& b) {
  Dual<P> r; r.v = a.v + b.v; DOSMA_DUAL_LOOP(a.d[i] + b.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_add(const Dual<P>& a, float b) {
  Dual<P> r; r.v = a.v + b; DOSMA_DUAL_LOOP(a.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_add(float a, const Dual<P>& b) {
  Dual<P> r; r.v = a + b.v; DOSMA_DUAL_LOOP(b.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_sub(const Dual<P>& a, const Dual<P>& b) {
  Dual<P> r; r.v = a.v - b.v; DOSMA_DUAL_LOOP(a.d[i] - b.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_sub(const Dual<P>& a, float b) {
  Dual<P> r; r.v = a.v - b; DOSMA_DUAL_LOOP(a.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_sub(float a, const Dual<P>& b) {
  Dual<P> r; r.v = a - b.v; DOSMA_DUAL_LOOP(-b.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_mul(const Dual<P>& a, const Dual<P>& b) {
  Dual<P> r; r.v = a.v * b.v; DOSMA_DUAL_LOOP(a.d[i] * b.v + a.v * b.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_mul(const Dual<P>& a, float b) {
  Dual<P> r; r.v = a.v * b; DOSMA_DUAL_LOOP(a.d[i] * b); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_mul(float a, const Dual<P>& b) {
  Dual<P> r; r.v = a * b.v; DOSMA_DUAL_LOOP(a * b.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_div(const Dual<P>& a, const Dual<P>& b) {
  Dual<P> r; r.v = a.v / b.v; DOSMA_DUAL_LOOP((a.d[i] - r.v * b.d[i]) / b.v); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_div(const Dual<P>& a, float b) {
  Dual<P> r; r.v = a.v / b; DOSMA_DUAL_LOOP(a.d[i] / b); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_div(float a, const Dual<P>& b) {
  Dual<P> r; r.v = a / b.v; DOSMA_DUAL_LOOP((-(r.v * b.d[i])) / b.v); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_neg(const Dual<P>& a) {
  Dual<P> r; r.v = -a.v; DOSMA_DUAL_LOOP(-a.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_exp(const Dual<P>& a) {
  Dual<P> r; r.v = expf(a.v); DOSMA_DUAL_LOOP(r.v * a.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_log(const Dual<P>& a) {
  Dual<P> r; r.v = logf(a.v); DOSMA_DUAL_LOOP(a.d[i] / a.v); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_sqrt(const Dual<P>& a) {
  Dual<P> r; r.v = sqrtf(a.v); DOSMA_DUAL_LOOP(a.d[i] / (r.v + r.v)); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_abs(const Dual<P>& a) {
  const float s = (float)(a.v > 0.0f) - (float)(a.v < 0.0f);
  Dual<P> r; r.v = fabsf(a.v); DOSMA_DUAL_LOOP(s * a.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_sin(const Dual<P>& a) {
  const float c = cosf(a.v);
  Dual<P> r; r.v = sinf(a.v); DOSMA_DUAL_LOOP(c * a.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_cos(const Dual<P>& a) {
  const float s = -sinf(a.v);
  Dual<P> r; r.v = cosf(a.v); DOSMA_DUAL_LOOP(s * a.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_tanh(const Dual<P>& a) {
  Dual<P> r; r.v = tanhf(a.v);
  const float k = 1.0f - r.v * r.v;
  DOSMA_DUAL_LOOP(k * a.d[i]); return r;
}
template <int P>
__device__ __forceinline__ Dual<P> op_pow(const Dual<P>& a, float c) {
  Dual<P> r; r.v = cpow(a.v, c);
  if (c == 1.0f) {
    DOSMA_DUAL_LOOP(a.d[i]);
  } else {
    const float k = c * cpow(a.v, c - 1.0f);
    DOSMA_DUAL_LOOP(k * a.d[i]);
  }
  return r;
}

#undef DOSMA_DUAL_LOOP

// The model's result as a V: a float result (a model term that does not
// depend on the parameters) becomes a dual number with zero derivatives.
template <class V>
struct Lift {
  __device__ __forceinline__ static V from(const V& a) { return a; }
};
template <int P>
struct Lift<Dual<P>> {
  __device__ __forceinline__ static Dual<P> from(const Dual<P>& a) { return a; }
  __device__ __forceinline__ static Dual<P> from(float a) {
    Dual<P> r;
    r.v = a;
#pragma unroll
    for (int i = 0; i < P; ++i) r.d[i] = 0.0f;
    return r;
  }
};

// ---- The LM loop.
template <class Model, int TT>
__device__ __forceinline__ float model_cost(const Voxel<TT>& v, int T, const float* p) {
  float c = -0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
    const float r = Model::template eval<float>(v.X(t), p) - v.Y(t);
    c += r * r;
  }
  return isfinite(c) ? c : INFINITY;
}

// ops/nlls.py::_chol_solve_unrolled, operation for operation.
template <int P>
__device__ __forceinline__ void chol_solve(const float (&A)[P][P], const float (&g)[P],
                                           float (&delta)[P]) {
  float L[P][P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        L[i][j] = sqrtf(nmax(s, 1e-30f));
      } else {
        L[i][j] = s / L[j][j];
      }
    }
  }
  float z[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * z[k];
    z[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    float s = z[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s = s - L[k][i] * delta[k];
    delta[i] = s / L[i][i];
  }
}

template <class Model, int TT>
__global__ void __launch_bounds__(kThreads)
generic_lm_kernel(const float* __restrict__ x, const float* __restrict__ y, long long y_st,
                  long long y_sn, const float* __restrict__ p0, long long p0_sp, long long p0_sn,
                  float* __restrict__ out, long long N, int T_rt, int max_iter, float ftol,
                  float xtol) {
  constexpr int P = Model::P;
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= N) return;

  const Voxel<TT> v(x, y + n * y_sn, y_st, T_rt);
  const int T = TT > 0 ? TT : T_rt;

  float p[P];
#pragma unroll
  for (int i = 0; i < P; ++i) p[i] = __ldg(p0 + i * p0_sp + n * p0_sn);

  float cost = model_cost<Model, TT>(v, T, p);
  const bool bad_init = !isfinite(cost);
  float lam = 1e-3f;
  bool latched = bad_init;
  for (int it = 0; it < max_iter && !latched; ++it) {
    Dual<P> pd[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      pd[j].v = p[j];
#pragma unroll
      for (int i = 0; i < P; ++i) pd[j].d[i] = (i == j) ? 1.0f : 0.0f;
    }
    float A[P][P], g[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      g[i] = -0.0f;
#pragma unroll
      for (int j = 0; j < P; ++j) A[i][j] = -0.0f;
    }
#pragma unroll
    for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
      const Dual<P> f = Model::template eval<Dual<P>>(v.X(t), pd);
      const float r = f.v - v.Y(t);
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) A[i][j] += f.d[i] * f.d[j];
        g[i] += f.d[i] * r;
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) A[i][i] = A[i][i] + lam * nmax(A[i][i], 1e-12f);

    float delta[P], np[P];
    chol_solve<P>(A, g, delta);
#pragma unroll
    for (int i = 0; i < P; ++i) np[i] = p[i] - delta[i];
    const float new_cost = model_cost<Model, TT>(v, T, np);

    const bool accept = new_cost < cost;
    const bool rel_decrease = (cost - new_cost) <= ftol * nmax(cost, 1e-30f);
    float step_ratio = 0.0f;
#pragma unroll
    for (int i = 0; i < P; ++i)
      step_ratio = nmax(step_ratio, fabsf(delta[i]) / nmax(fabsf(p[i]), 1e-12f));
    const bool small_step = step_ratio <= xtol;
    const bool gn_small = small_step && (lam <= 1e-2f);
    const bool at_floor = !accept && (lam >= 1e2f);
    latched = (accept && (rel_decrease || small_step)) || gn_small || at_floor;

    if (accept) {
#pragma unroll
      for (int i = 0; i < P; ++i) p[i] = np[i];
      cost = new_cost;
    }
    lam = accept ? nmax(lam * 0.33f, 1e-12f) : nmin(lam * 3.0f, 1e10f);
  }

  float ysum = -0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) ysum += v.Y(t);
  const float y_mean = ysum / (float)T;
  float ss_res = -0.0f, ss_tot = -0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
    const float r = Model::template eval<float>(v.X(t), p) - v.Y(t);
    ss_res += r * r;
    const float d = v.Y(t) - y_mean;
    ss_tot += d * d;
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    finite = finite && isfinite(p[i]);
    out[i * N + n] = p[i];
  }
  out[P * N + n] = 1.0f - ss_res / (ss_tot + 1e-8f);
  out[(P + 1) * N + n] = (latched && finite && !bad_init) ? 1.0f : 0.0f;
}

template <class Model, int TT>
void generic_lm_launch_T(const float* x, const float* y, long long y_st, long long y_sn,
                         const float* p0, long long p0_sp, long long p0_sn, float* out,
                         long long N, int T, int max_iter, float ftol, float xtol,
                         cudaStream_t stream) {
  const long long blocks = (N + kThreads - 1) / kThreads;
  generic_lm_kernel<Model, TT><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol);
}

// x (T,) f32; y (T, N) f32 read at y[t * y_st + n * y_sn]; p0 the seeds
// read at p0[i * p0_sp + n * p0_sn] (p0_sn = 0 broadcasts one seed); out
// (P + 2, N) f32 contiguous, rows [p_0 .. p_{P-1}, r2, converged]. Launches
// on `stream`, does not synchronise, and returns cudaGetLastError().
template <class Model>
int generic_lm_launch(const float* x, const float* y, long long y_st, long long y_sn,
                      const float* p0, long long p0_sp, long long p0_sn, float* out, long long N,
                      int T, int max_iter, float ftol, float xtol, void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if ((N + kThreads - 1) / kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
#define DOSMA_GENERIC_CASE(TV)                                                                 \
  case TV:                                                                                     \
    generic_lm_launch_T<Model, TV>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter,    \
                                   ftol, xtol, s);                                             \
    break;
    DOSMA_GENERIC_CASE(1)
    DOSMA_GENERIC_CASE(2)
    DOSMA_GENERIC_CASE(3)
    DOSMA_GENERIC_CASE(4)
    DOSMA_GENERIC_CASE(5)
    DOSMA_GENERIC_CASE(6)
    DOSMA_GENERIC_CASE(7)
    DOSMA_GENERIC_CASE(8)
#undef DOSMA_GENERIC_CASE
    default:
      generic_lm_launch_T<Model, 0>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter,
                                    ftol, xtol, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace dosma
