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
// PxP Cholesky per echo and iteration: issue-bound, like the other fits.
// On phase 6's data (a * exp(b x) + c on 4.19M voxels x 5 points) a voxel
// latches after 5.88 iterations on average but the slowest of 32
// consecutive voxels after 2.56 times that, which is what a one-voxel-a-
// thread warp runs (chip_smoke.py phase 6, on an H100 80GB HBM3 at a 700 W
// power limit: 1.22-1.24 ms before lane refill, 0.80 ms with it).
// The design: echoes in registers for T <= 8 (one instantiation per T) and
// each voxel frozen at its own latch (the TPU kernel kept polishing latched
// lanes until its block had latched), as in monoexp_lm.cu and biexp_lm.cu;
// but where those give each thread one voxel, so that a warp runs as many
// iterations as the slowest of its 32 voxels, this kernel is persistent and
// refills a lane with the next voxel as soon as its voxel latches (see
// generic_lm_kernel). There is no ragged edge to mask: a lane past N stops
// (the TPU kernel padded with the model evaluated at the pad seed).
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
// The sum of squared residuals at p, in echo order (r2's ss_res), and the
// cost: that sum, +inf where it is not finite.
template <class Model, int TT>
__device__ __forceinline__ float model_ssr(const Voxel<TT>& v, int T, const float* p) {
  float c = -0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
    const float r = Model::template eval<float>(v.X(t), p) - v.Y(t);
    c += r * r;
  }
  return c;
}

__device__ __forceinline__ float cost_of(float ssr) { return isfinite(ssr) ? ssr : INFINITY; }

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

// One voxel's fit in flight: its echoes, parameters, cost, damping and
// latch. Each pass() is one iteration of the loop of ops/nlls.py::_lm_loop;
// the first also takes the seed's cost from the values of its dual
// evaluation (a dual operation computes its value exactly as the float one
// does, so this is the seed's model_ssr to the bit), so that starting a
// voxel costs no model evaluation of its own, and neither does finishing
// one: r2's ss_res is the sum of squared residuals kept beside the cost.
template <class Model, int TT>
struct Fit {
  static constexpr int P = Model::P;
  Voxel<TT> v;
  float p[P];
  float cost, ssr, lam;
  bool costed, bad_init, latched;
  int it;

  // Starts a voxel from its echoes ys (TT > 0; read through y otherwise)
  // and seeds, loaded beforehand.
  __device__ __forceinline__ void start(const float* x, const float* y, long long y_st, int T_rt,
                                        const float* ys, const float* seed) {
    v.xg = x;
    v.yg = y;
    v.st = y_st;
    v.T = TT > 0 ? TT : T_rt;
    if constexpr (TT > 0) {
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        v.xs[t] = __ldg(x + t);
        v.ys[t] = ys[t];
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) p[i] = seed[i];
    lam = 1e-3f;
    costed = bad_init = latched = false;
    it = 0;
  }

  // The voxel is finished: latched (a seed whose cost is not finite latches
  // at once) or out of iterations.
  __device__ __forceinline__ bool done(int max_iter) const {
    return costed && (latched || it >= max_iter);
  }

  __device__ __forceinline__ void pass(int max_iter, float ftol, float xtol) {
    const int T = v.T;
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
    float c = -0.0f;
#pragma unroll
    for (int t = 0; t < (TT > 0 ? TT : T); ++t) {
      const Dual<P> f = Model::template eval<Dual<P>>(v.X(t), pd);
      const float r = f.v - v.Y(t);
      c += r * r;
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) A[i][j] += f.d[i] * f.d[j];
        g[i] += f.d[i] * r;
      }
    }
    if (!costed) {
      costed = true;
      ssr = c;
      cost = cost_of(c);
      bad_init = !isfinite(cost);
      latched = bad_init;
      if (latched || it >= max_iter) return;
    }
#pragma unroll
    for (int i = 0; i < P; ++i) A[i][i] = A[i][i] + lam * nmax(A[i][i], 1e-12f);

    float delta[P], np[P];
    chol_solve<P>(A, g, delta);
#pragma unroll
    for (int i = 0; i < P; ++i) np[i] = p[i] - delta[i];
    const float new_ssr = model_ssr<Model, TT>(v, T, np);
    const float new_cost = cost_of(new_ssr);

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
      ssr = new_ssr;
    }
    lam = accept ? nmax(lam * 0.33f, 1e-12f) : nmin(lam * 3.0f, 1e10f);
    ++it;
  }

  // Writes voxel n's packed rows [p_0 .. p_{P-1}, r2, converged].
  __device__ __forceinline__ void finish(float* out, long long N, long long n) const {
    const int T = v.T;
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
    bool finite = true;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      finite = finite && isfinite(p[i]);
      out[i * N + n] = p[i];
    }
    out[P * N + n] = 1.0f - ssr / (ss_tot + 1e-8f);
    out[(P + 1) * N + n] = (latched && finite && !bad_init) ? 1.0f : 0.0f;
  }
};

// A persistent kernel with lane refill. Each lane of a warp holds one voxel
// and runs one LM iteration of it per pass; a lane whose voxel latched (or
// whose initial cost was not finite) writes its result and starts the next
// voxel. Each lane also keeps the voxel after that in a slot, its echoes
// and seeds already loaded, so a refill waits for no load: the slot's next
// index comes from the counter *next, which the warp reads in batches of
// 32 indices, one batch ahead, and its loads are in flight while the
// current voxel iterates. So a warp no longer runs as many iterations as
// its slowest voxel of 32: it stops when the counter has passed N and none
// of its lanes holds a voxel. Each voxel is frozen at its own latch, so its
// result depends only on its own data and seed, and the assignment of
// voxels to lanes changes no bit of it.
template <class Model, int TT>
__global__ void __launch_bounds__(kThreads)
generic_lm_kernel(const float* __restrict__ x, const float* __restrict__ y, long long y_st,
                  long long y_sn, const float* __restrict__ p0, long long p0_sp, long long p0_sn,
                  float* __restrict__ out, long long N, int T_rt, int max_iter, float ftol,
                  float xtol, unsigned long long* __restrict__ next) {
  constexpr int P = Model::P;
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;

  Fit<Model, TT> fit;
  long long n = 0, n_slot = 0;
  float slot_y[TT > 0 ? TT : 1], slot_p[P];
  bool active = false, slot = false, exhausted = false;
  // The warp takes voxel indices from the counter in batches of kBatch.
  // Lane 0 keeps the next batch's atomicAdd in flight and its result is
  // read only when the current batch runs out, so no claim waits for an
  // atomic (but the first).
  constexpr unsigned kBatch = 32;
  unsigned long long pending = 0;
  if (lane == 0) pending = atomicAdd(next, (unsigned long long)kBatch);
  unsigned long long batch = __shfl_sync(kAll, pending, 0);
  if (lane == 0) pending = atomicAdd(next, (unsigned long long)kBatch);
  unsigned used = 0;  // indices of `batch` handed out
  for (;;) {
    // Lanes with an empty slot claim the next voxels and start their loads.
    const bool claim = !slot && !exhausted;
    const unsigned ask = __ballot_sync(kAll, claim);
    if (ask) {
      const unsigned count = __popc(ask);
      const bool cross = used + count >= kBatch;
      unsigned long long following = 0;
      if (cross) {
        following = __shfl_sync(kAll, pending, 0);
        if (lane == 0) pending = atomicAdd(next, (unsigned long long)kBatch);
      }
      if (claim) {
        const unsigned pos = used + __popc(ask & below);
        n_slot = (long long)(pos < kBatch ? batch + pos : following + (pos - kBatch));
        if (n_slot < N) {
          if constexpr (TT > 0) {
#pragma unroll
            for (int t = 0; t < TT; ++t) slot_y[t] = __ldg(y + n_slot * y_sn + t * y_st);
          }
#pragma unroll
          for (int i = 0; i < P; ++i) slot_p[i] = __ldg(p0 + i * p0_sp + n_slot * p0_sn);
          slot = true;
        } else {
          exhausted = true;  // the counter only grows: every later index is past N too
        }
      }
      if (cross) {
        batch = following;
        used = used + count - kBatch;
      } else {
        used += count;
      }
    }
    // Idle lanes start the voxel in their slot.
    if (!active && slot) {
      n = n_slot;
      fit.start(x, y + n * y_sn, y_st, T_rt, slot_y, slot_p);
      active = true;
      slot = false;
    }
    if (!__any_sync(kAll, active)) break;  // then no lane has a slot or a voxel to claim
    if (active) {
      fit.pass(max_iter, ftol, xtol);
      if (fit.done(max_iter)) {
        fit.finish(out, N, n);
        active = false;
      }
    }
  }
}

template <class Model, int TT>
int generic_lm_launch_T(const float* x, const float* y, long long y_st, long long y_sn,
                        const float* p0, long long p0_sp, long long p0_sn, float* out,
                        long long N, int T, int max_iter, float ftol, float xtol,
                        unsigned long long* next, cudaStream_t stream) {
  // As many blocks as the card holds at once, and no more than the voxels
  // need; every block then runs until the counter passes N.
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, generic_lm_kernel<Model, TT>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long need = (N + kThreads - 1) / kThreads;
  const long long blocks = need < (long long)per_sm * sms ? need : (long long)per_sm * sms;
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  err = cudaMemsetAsync(next, 0, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  generic_lm_kernel<Model, TT><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T, max_iter, ftol, xtol, next);
  return (int)cudaGetLastError();
}

// x (T,) f32; y (T, N) f32 read at y[t * y_st + n * y_sn]; p0 the seeds
// read at p0[i * p0_sp + n * p0_sn] (p0_sn = 0 broadcasts one seed); out
// (P + 2, N) f32 contiguous, rows [p_0 .. p_{P-1}, r2, converged]; next: a
// workspace of one 64-bit counter on the device, which the launch zeroes on
// `stream` (a workspace per launch, not a __device__ global: launches on
// two streams must not share it). Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 on success).
template <class Model>
int generic_lm_launch(const float* x, const float* y, long long y_st, long long y_sn,
                      const float* p0, long long p0_sp, long long p0_sn, float* out, long long N,
                      int T, int max_iter, float ftol, float xtol, unsigned long long* next,
                      void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
#define DOSMA_GENERIC_CASE(TV)                                                                 \
  case TV:                                                                                     \
    return generic_lm_launch_T<Model, TV>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T,       \
                                          max_iter, ftol, xtol, next, s);
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
      return generic_lm_launch_T<Model, 0>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T,
                                           max_iter, ftol, xtol, next, s);
  }
}

}  // namespace dosma
