#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on a CUDA card, and check them.

Usage, from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --quick    # phases 1-3 only: build, small cases

Phases (any failure raises and exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build every kernel from dosma_tpu_torch/csrc/, one nvcc process per
     source, all started together: monoexp_lm.cu, biexp_lm.cu,
     warp_grid.cu and the generic LM kernel generated for each model used
     below; print the nvcc seconds and the ptxas register and spill counts;
  3. hold each kernel against its plain PyTorch version on the card at
     small shapes: edge cases (all-zero voxel, y_bounds, nan_policy="keep"
     with one iteration, N not a multiple of the block, per-voxel p0, a
     seed whose cost is inf), several T, and for the generic kernel models
     with P = 1, 2, 3, 4 built from every whitelisted operation.
     Tolerance: |Δ| <= 1e-5 * max(1, |v|) on every parameter and r2 of
     every voxel, identical NaN and infinity positions, converged flags
     equal on >= 99.9% of voxels. The warp kernel, orders 1 and 3: identity,
     a rotation with a shift, a map partly outside the volume, an axis
     permutation, NB = 1, 3, 9, one matrix per group, output shapes that
     differ from the source and are not multiples of 8; every voxel within
     1e-5 * max(1, |v|) (bit equality is the aim, and reported);
  4. monoexponential relaxometry (the first slice's main path): four
     512x512x64 echo volumes on the card (16.7M voxels, noisy data made
     from seed 0) through MonoExponentialFit(bounds=(0, 100),
     tc0="polyfit").fit and the T2 map's regional metrics; the kernel's
     launch count over that run; scipy parity of the map on 2,000 voxels
     (relative RMSE of tc < 5e-3); kernel and plain version compared on
     every voxel with the tolerance above, and timed (CUDA events, median
     of 5 after a warm-up);
  5. biexponential fit at full width: 512x512x16 voxels x 8 echoes (the
     data of bench.py's biexp config, seed 0) as volumes on the card
     through CurveFitter(biexponential).fit; exactly one biexp_lm launch;
     the maps stay on the card; kernel and plain version compared on every
     voxel; scipy parity on 2,000 voxels (relative RMSE of each parameter
     < PARITY_GATE_FIT); converged fraction; kernel, plain version and warm
     fit timed;
  6. a user's model at full width: a * exp(b x) + c on 512x512x16 voxels x
     5 points (bench.py's generic config, seed 0) through curve_fit on the
     card; exactly one generic_lm launch; the same checks and times as
     phase 5, and the time of lm_fit (the torch.func.jvp engine) on the
     same data;
  7. matrix registration at full width: bench.py's phantom (192x192x48,
     voxels 0.5x0.6x2.0 mm, a bright box plus noise, moving = fixed rolled
     by (4, -3, 1), RandomState(5)) as host volumes through
     register(..., "affine") on the default device (the card): first call
     and warm wall (median of 3); exactly one warp_grid launch in one warm
     call; recovery error against the known shift < 0.5 voxel; RMSE against
     fixed inside the box falls >= 4x; apply_warp of a 4-volume stack with
     the written transform: exactly one launch; both warps (order 3, 196x196x52
     coefficients onto 192x192x48, NB = 1 and 4) held against the plain
     version on the same sources and B, every voxel within the tolerance of
     phase 3;
  8. the warp kernel at a knee scan's size: 4 volumes of 384x384x160 f32
     (OAI DESS) under bench.py's rotation, orders 1 and 3: kernel and plain
     version compared on every voxel; kernel, plain version, the order-3
     prefilter alone and, for order 1, F.grid_sample (the library yardstick,
     never used by the port) timed (CUDA events, median of 5); bytes,
     achieved bandwidth and the bound; the bench size 192x192x48, order 1,
     one volume.
Each path (phases 4, 5, 6, 7) runs with every launch count set to 0 just
before it and read just after. The last two lines are one JSON object
with every kernel (its bound: the larger of the bytes it must move over
3.35 TB/s and its float32 operations over 67 TFLOP/s) and the result
object. It imports nothing of JAX.
"""

import argparse
import concurrent.futures
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SHAPE = (512, 512, 64)
ECHO_TIMES = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
NOISE_SIGMA = 0.005
TOL = 1e-5  # |Δ| <= TOL * max(1, |v|) between kernel and plain version
CONV_AGREE = 0.999
PARITY_N = 2000
PARITY_GATE = 5e-3

FIT_SHAPE = (512, 512, 16)  # phases 5 and 6 (bench.py:846, :886)
BIEXP_X = np.linspace(0.0, 10.0, 8).astype(np.float32)
BIEXP_P0 = (1.0, -0.5, 0.4, -0.04)
GENERIC_X = np.array([5.0, 15.0, 30.0, 50.0, 80.0], np.float32)
GENERIC_P0 = (1.0, -1 / 30, 0.0)
# Noiseless data: on the CPU the plain versions reach scipy to <= 3e-5
# relative RMSE on every parameter; the gate leaves room for float32.
PARITY_GATE_FIT = 1e-3

REG_SHAPE = (192, 192, 48)  # phase 7 (bench.py:650-681)
REG_AFFINE = np.diag([0.5, 0.6, 2.0, 1.0])
REG_SHIFT = (4, -3, 1)  # moving = fixed rolled by this many voxels
KNEE_SHAPE = (384, 384, 160)  # phase 8: OAI DESS matrix
KNEE_VOLUMES = 4
WARP_AFFINE = np.diag([0.5, 0.5, 2.0, 1.0])  # bench.py:697-706
WARP_ANGLE, WARP_SHIFT = 0.07, (1.2, -0.7, 0.4)

# H100 SXM peaks (NVIDIA data sheet): the bound of a kernel is the larger of
# its bytes over the memory rate and its float32 operations over the
# float32 (non-tensor-core) rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def offset_exp(x, a, b, c):
    """Phase 6's model: a user's function, not a library model."""
    return a * torch.exp(b * x) + c


# Generic kernel models for the small cases, P = 1..4; together they use
# every whitelisted operation.
def rate_only(x, a):
    return torch.exp(-x / a)


def amp_tc(x, a, b):
    return a * torch.exp(-x / b)


def noise_floor(x, a, b, c):
    return torch.sqrt((a * torch.exp(b * x)) ** 2 + c ** 2)


def abs_biexp(x, a1, b1, a2, b2):
    return a1 * torch.exp(b1 * x) + torch.abs(a2) * torch.exp(b2 * x)


def all_ops(x, a, b):
    return (torch.log(abs(a) + 1.0) * torch.cos(x / 40.0) + torch.tanh(b * x) ** 3
            - torch.sin(x / 60.0) / (b * b + 1.0) + (x + 1.0) ** -1 * a
            + (b * b + 1.0) ** 2.5 * 0.01 + (x + a * a) ** 0.5 - (-a) * 0.1)


GENERIC_MODELS = {  # name -> (model, nparams, true-parameter sampler, p0)
    "P1_rate": (rate_only, 1, lambda rs, N: [rs.rand(N) * 70 + 10], [30.0]),
    "P2_amp_tc": (amp_tc, 2, lambda rs, N: [rs.rand(N) + 0.5, rs.rand(N) * 70 + 10],
                  [1.0, 30.0]),
    "P2_all_ops": (all_ops, 2, lambda rs, N: [0.5 + rs.rand(N), 0.01 + 0.02 * rs.rand(N)],
                   [1.0, 0.02]),
    "P3_noise_floor": (noise_floor, 3, lambda rs, N: [
        rs.rand(N) + 0.5, -1 / (rs.rand(N) * 70 + 10), 0.02 + 0.1 * rs.rand(N)],
        [1.0, -1 / 30, 0.05]),
    "P3_offset": (offset_exp, 3, lambda rs, N: [
        rs.rand(N) + 0.5, -1 / (rs.rand(N) * 70 + 10), 0.2 * rs.rand(N)], list(GENERIC_P0)),
    "P4_abs_biexp": (abs_biexp, 4, lambda rs, N: [
        0.8 + 0.4 * rs.rand(N), -(0.15 + 0.1 * rs.rand(N)),
        0.3 + 0.3 * rs.rand(N), -(0.008 + 0.006 * rs.rand(N))], [0.8, -0.2, 0.4, -0.01]),
}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def compare(name, got, ref):
    """Kernel vs plain outputs (popt (N, P), r2 (N,), converged (N,)).

    Every parameter and r2 agree within TOL * max(1, |v|) on every voxel,
    with identical NaN and infinity positions; converged flags agree on at
    least CONV_AGREE of the voxels. Returns (max |Δ| on the parameters,
    max |Δ| on r2, converged agreement).
    """
    (pk, rk, ck), (pr, rr, cr) = got, ref
    vk = torch.cat([pk, rk[:, None]], dim=1)
    vr = torch.cat([pr, rr[:, None]], dim=1)
    check(torch.equal(torch.isnan(vk), torch.isnan(vr)), f"{name}: NaN positions differ")
    fin = torch.isfinite(vk)
    check(torch.equal(fin, torch.isfinite(vr)), f"{name}: infinity positions differ")
    inf = ~fin & ~torch.isnan(vk)
    check(torch.equal(vk[inf], vr[inf]), f"{name}: infinities of opposite sign")
    diff = torch.where(fin, (vk - vr).abs(), torch.zeros_like(vk))
    outside = (diff > TOL * torch.clamp(vr.abs(), min=1.0)).sum(dim=0)
    col_err = diff.amax(dim=0)
    err_p, err_r2 = float(col_err[:-1].max()), float(col_err[-1])
    agree = float((ck == cr).float().mean())
    check(int(outside.sum()) == 0,
          f"{name}: voxels outside tolerance (params..., r2) {outside.tolist()}, "
          f"max |Δ| {col_err.tolist()}")
    check(agree >= CONV_AGREE, f"{name}: converged flags agree on only {agree:.5f}")
    return err_p, err_r2, agree


def compare_packed(name, pk, pr, nparams):
    """compare() on raw packed rows [params..., r2, converged]: r2 of every
    voxel, before a NaN policy zeroes any."""
    P = nparams
    return compare(name, (pk[:P].T, pk[P], pk[P + 1]), (pr[:P].T, pr[P], pr[P + 1]))


def time_ms(fn, reps=5):
    """Median and all of ``reps`` CUDA-event times of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def _wrappers():
    from dosma_tpu_torch.ops.biexp import biexp_lm
    from dosma_tpu_torch.ops.generic_lm import generic_lm
    from dosma_tpu_torch.ops.monoexp import monoexp_lm
    from dosma_tpu_torch.ops.warp import warp_grid

    return {"monoexp_lm": monoexp_lm, "biexp_lm": biexp_lm, "generic_lm": generic_lm,
            "warp_grid": warp_grid}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def expect_launches(path, **want):
    counts = launch_counts()
    expected = {name: want.get(name, 0) for name in counts}
    check(counts == expected, f"the {path} path launched {counts}, not {expected}")
    return counts


def bound(nbytes, flops):
    """(bound ms, "bytes" or "operations") for this much work on the card."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lm_bound(yT, out_rows, flops_per_voxel):
    """Bound of an LM kernel: y read once, the packed rows written once; the
    operation side counts one LM iteration a voxel (iteration counts are not
    measured, so this is a lower bound of the work)."""
    T, N = yT.shape
    nbytes = T * N * 4 + out_rows * N * 4
    return bound(nbytes, flops_per_voxel * N)


def scipy_parity(name, model_np, x, Y, popt_flat, idx, p0):
    """Relative RMSE of each parameter of ``popt_flat[idx]`` against
    per-voxel scipy fits of the float64 data."""
    import scipy.optimize as sop

    ref = np.stack([sop.curve_fit(model_np, np.float64(x), np.float64(Y[i]), p0=p0,
                                  maxfev=2000)[0] for i in idx])
    ours = popt_flat[torch.from_numpy(idx).to(popt_flat.device)].cpu().numpy().astype(np.float64)
    ok = np.isfinite(ours).all(1)
    check(ok.mean() > 0.99, f"{name} parity: only {ok.mean():.4f} of sampled voxels finite")
    rel = np.sqrt(np.mean(((ours[ok] - ref[ok]) / ref[ok]) ** 2, axis=0))
    print(f"scipy parity {name}: relative RMSE per parameter {rel.tolist()} over "
          f"{int(ok.sum())} voxels (gate {PARITY_GATE_FIT})")
    check(bool((rel < PARITY_GATE_FIT).all()), f"{name} scipy parity {rel.tolist()}")
    return float(rel.max())


# ----------------------------------------------------------------------
# Phase 2: build
# ----------------------------------------------------------------------
def build_all():
    """Start every nvcc together; print each build's seconds and ptxas report."""
    from dosma_tpu_torch.ops import _build
    from dosma_tpu_torch.ops.generic_lm import build_kernel, compile_model

    jobs = {"monoexp_lm.cu": lambda: _build.load_library("monoexp_lm"),
            "biexp_lm.cu": lambda: _build.load_library("biexp_lm"),
            "warp_grid.cu": lambda: _build.load_library("warp_grid")}
    for name, (model, nparams, _, _) in GENERIC_MODELS.items():
        program = compile_model(model, nparams)
        jobs[f"generic_lm ({name})"] = lambda p=program: build_kernel(p)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = {k: pool.submit(fn) for k, fn in jobs.items()}
        libs = {k: f.result() for k, f in libs.items()}
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s wall, in parallel")
    for name, lib in libs.items():
        log = lib.build_log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(a) + int(b) for a, b in
                  re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        print(f"  {name}: nvcc {lib.build_seconds:.2f} s; ptxas: {len(regs)} kernels, "
              f"registers {min(regs, default=0)}-{max(regs, default=0)}, "
              f"spill bytes {sum(spills)}")
        for line in log.splitlines():
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                print("    ptxas:", line.strip())


# ----------------------------------------------------------------------
# Phase 3: small cases
# ----------------------------------------------------------------------
def mono_small_cases(rs):
    """(name, x, y (N, T), p0, kwargs) edge cases of the monoexp fit."""
    def data(N, x, noise=0.0):
        b = -1 / (rs.rand(N).astype(np.float32) * 70 + 10)
        Y = np.exp(b[:, None] * x[None, :])
        if noise:
            Y = Y + noise * rs.randn(N, x.size)
        return Y.astype(np.float32)

    x4 = ECHO_TIMES
    p0 = np.array([1.0, -1 / 30], np.float32)
    cases = [("noiseless_p0", x4, data(1024, x4), p0, {"max_iter": 50})]
    Y = data(256, x4)
    Y[7] = 0
    cases.append(("all_zero_voxel", x4, Y, p0, {}))
    Y = data(256, x4)
    Y[3] = 0.7
    Y[11] = np.exp(0.02 * x4)
    cases.append(("constant_and_growing", x4, Y, p0, {}))
    cases.append(("n_not_multiple_of_block", x4, data(1000, x4), p0, {}))
    pv = np.stack([np.ones(500, np.float32), np.full(500, -1 / 30, np.float32)], axis=1)
    cases.append(("per_voxel_p0", x4, data(500, x4), pv, {"max_iter": 50}))
    cases.append(("polyfit_seed_noisy", x4, data(4096, x4, NOISE_SIGMA), None, {"max_iter": 100}))
    cases.append(("y_bounds", x4, data(400, x4), p0, {"y_bounds": (0.1, 1.0)}))
    cases.append(("nan_policy_keep_one_iter", x4, data(256, x4), p0,
                  {"nan_policy": "keep", "max_iter": 1}))
    for T in (2, 3, 4, 8, 11):
        uni = (10.0 * np.arange(1, T + 1)).astype(np.float32)
        nonuni = np.cumsum(np.linspace(4.0, 12.0, T)).astype(np.float32)
        for label, x in (("uniform", uni), ("nonuniform", nonuni)):
            cases.append((f"T{T}_{label}", x, data(777, x, NOISE_SIGMA), None, {}))
    return cases


def biexp_small_cases(rs):
    """(name, x, y (N, T), p0, kwargs) edge cases of the biexp fit."""
    def data(N, T=8, noise=0.0):
        x = np.linspace(0.0, 10.0, T).astype(np.float32)
        a1, b1 = 0.8 + 0.4 * rs.rand(N), -(0.4 + 0.2 * rs.rand(N))
        a2, b2 = 0.3 + 0.3 * rs.rand(N), -(0.03 + 0.03 * rs.rand(N))
        Y = a1[:, None] * np.exp(b1[:, None] * x) + a2[:, None] * np.exp(b2[:, None] * x)
        if noise:
            Y = Y * (1 + noise * rs.randn(N, T))
        return x, Y.astype(np.float32)

    p0 = np.array(BIEXP_P0, np.float32)
    kw = {"max_iter": 100}
    cases = [("noiseless", *data(1024), p0, kw), ("noisy_2pct", *data(1024, noise=0.02), p0, kw)]
    x, Y = data(256)
    Y[7] = 0
    cases.append(("all_zero_voxel", x, Y, p0, kw))
    cases.append(("y_bounds", *data(400), p0, dict(kw, y_bounds=(0.3, 1.5))))
    cases.append(("nan_policy_keep_one_iter", *data(256), p0, {"nan_policy": "keep", "max_iter": 1}))
    cases.append(("n_not_multiple_of_block", *data(1000, noise=0.01), p0, kw))
    pv = np.tile(p0, (500, 1)) * (1 + 0.1 * rs.randn(500, 1)).astype(np.float32)
    pv[9, 1] = 100.0  # exp(100 * 10) overflows: this voxel's initial cost is inf
    cases.append(("per_voxel_p0_bad_init", *data(500, noise=0.01), pv, kw))
    for T in (2, 5, 8, 11):
        cases.append((f"T{T}", *data(777, T=T, noise=0.01), p0, kw))
    return cases


def generic_small_cases(rs):
    """(name, model, x, y (N, T), p0, kwargs) cases of the generic fit."""
    def data(key, N, x, noise=0.0):
        model, _, sample, _ = GENERIC_MODELS[key]
        truth = [torch.from_numpy(v.astype(np.float32)) for v in sample(rs, N)]
        Y = model(torch.from_numpy(x)[:, None], *truth).T.numpy()
        if noise:
            Y = Y + noise * rs.randn(*Y.shape)
        return Y.astype(np.float32)

    x5 = GENERIC_X
    kw = {"max_iter": 60}
    cases = []
    for key, (model, _, _, p0) in GENERIC_MODELS.items():
        cases.append((f"{key}_noisy", model, x5, data(key, 1000, x5, 0.01),
                      np.array(p0, np.float32), kw))
    p0 = np.array(GENERIC_P0, np.float32)
    Y = data("P3_offset", 256, x5)
    Y[7] = 0
    cases.append(("P3_all_zero_voxel", offset_exp, x5, Y, p0, kw))
    cases.append(("P3_y_bounds", offset_exp, x5, data("P3_offset", 400, x5), p0,
                  dict(kw, y_bounds=(0.2, 1.5))))
    cases.append(("P3_keep_one_iter", offset_exp, x5, data("P3_offset", 256, x5), p0,
                  {"nan_policy": "keep", "max_iter": 1}))
    pv = np.tile(p0, (500, 1)) * (1 + 0.1 * rs.randn(500, 1)).astype(np.float32)
    pv[5, 1] = 100.0  # exp(100 * 80) overflows: this voxel's initial cost is inf
    cases.append(("P3_per_voxel_p0_bad_init", offset_exp, x5,
                  data("P3_offset", 500, x5, 0.01), pv, kw))
    for T in (2, 5, 8, 11):
        x = (10.0 * np.arange(1, T + 1)).astype(np.float32)
        cases.append((f"P2_T{T}", amp_tc, x, data("P2_amp_tc", 777, x, 0.01),
                      np.array([1.0, 30.0], np.float32), kw))
    return cases


def rotation_B(shape, deg, shift, scale=1.0):
    """Index-space map (3x4): rotation about axis 2 around the volume centre,
    an isotropic scale and a shift."""
    a = np.deg2rad(deg)
    R = scale * np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    c = (np.asarray(shape) - 1) / 2.0
    return np.concatenate([R, (c - R @ c + np.asarray(shift))[:, None]], axis=1).astype(np.float32)


def warp_small_cases():
    """(name, NB, source shape, output shape, B (3x4 or (G, 3, 4)))."""
    perm = np.array([[0, 0, 1, 2.5], [0, 1, 0, 0.5], [1, 0, 0, -1.0]], np.float32)
    return [
        ("identity", 2, (20, 21, 6), (20, 21, 6), np.eye(4, dtype=np.float32)[:3]),
        ("rotation_shift", 2, (22, 20, 7), (22, 20, 7), rotation_B((22, 20, 7), 3, (0.7, -1.3, 0.4))),
        ("nb1", 1, (20, 20, 5), (20, 20, 5), rotation_B((20, 20, 5), -2, (0.3, 0.2, -0.6))),
        ("nb3", 3, (20, 20, 5), (20, 20, 5), rotation_B((20, 20, 5), 2.5, (-0.4, 0.9, 0.1))),
        ("nb9", 9, (10, 9, 6), (11, 7, 5), rotation_B((10, 9, 6), 4, (0.2, 0.3, 0.1))),
        ("partly_outside", 2, (20, 22, 6), (20, 22, 6),
         rotation_B((20, 22, 6), 1, (6.5, -5.2, 2.3), 1.1)),
        ("other_output_shape", 2, (22, 20, 7), (19, 23, 5), rotation_B((22, 20, 7), 1.5, (0.5, -0.5, 0.8))),
        ("axis_permutation", 2, (9, 8, 10), (10, 8, 9), perm),
        ("one_matrix_per_group", 4, (33, 29, 17), (31, 35, 13),
         np.stack([rotation_B((33, 29, 17), 5, (0.5, 0, 0)), rotation_B((33, 29, 17), -3, (0, 0.7, 0.2))])),
        ("nb4_bench_like", 4, (64, 60, 24), (64, 60, 24), rotation_B((64, 60, 24), 4, (1.2, -0.7, 0.4))),
    ]


def compare_warp(name, got, ref):
    """Every voxel within TOL * max(1, |v|), identical NaN positions.
    Returns (max |Δ|, bit equal)."""
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    check(torch.equal(torch.isnan(got), torch.isnan(ref)), f"{name}: NaN positions differ")
    diff = torch.nan_to_num((got - ref).abs(), nan=0.0)
    outside = int((diff > TOL * torch.clamp(ref.abs(), min=1.0)).sum())
    err = float(diff.max()) if diff.numel() else 0.0
    check(outside == 0, f"{name}: {outside} voxels outside tolerance, max |Δ| {err}")
    return err, bool(torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref)))


def warp_small(dev):
    """Phase 3, warp kernel: each case and order against the plain version."""
    from dosma_tpu_torch.ops.warp import prepare_sources, warp_grid, warp_grid_reference

    worst, n_equal, n_cases = 0.0, 0, 0
    rs = np.random.RandomState(4)
    for name, nb, src_shape, out_shape, B in warp_small_cases():
        vols = torch.from_numpy((rs.rand(nb, *src_shape) * 4 - 1).astype(np.float32)).to(dev)
        Bt = torch.from_numpy(B).to(dev)
        for order in (1, 3):
            srcs = prepare_sources(vols, order)
            got = warp_grid(srcs, Bt, out_shape, order)
            torch.cuda.synchronize()
            ref = warp_grid_reference(srcs, Bt, out_shape, order)
            torch.cuda.synchronize()
            err, equal = compare_warp(f"warp_grid {name} order {order}", got, ref)
            worst = max(worst, err)
            n_equal += equal
            n_cases += 1
            print(f"compare warp_grid {name} order {order}: NB={nb} {src_shape} -> {out_shape} "
                  f"max|Δ|={err:.3g} bit-equal={equal}")
    print(f"warp_grid small cases: {n_equal} of {n_cases} bit-equal, worst |Δ| {worst:.3g}")
    return worst


def small_cases(dev):
    """Phase 3: every kernel against its plain version. Returns the
    largest |Δ| on parameters and r2 for each kernel."""
    from dosma_tpu_torch.ops.biexp import biexp_lm, biexp_lm_reference
    from dosma_tpu_torch.ops.generic_lm import compile_model, generic_lm, generic_lm_reference
    from dosma_tpu_torch.ops.monoexp import monoexp_lm, monoexp_lm_reference

    worst = {"monoexp_lm": 0.0, "biexp_lm": 0.0, "generic_lm": 0.0, "warp_grid": 0.0}

    def run(kernel, name, fn, ref_fn, args, kw, shape):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        ref = ref_fn(*args, **kw)
        torch.cuda.synchronize()
        err, err_r2, agree = compare(f"{kernel} {name}", got, ref)
        worst[kernel] = max(worst[kernel], err, err_r2)
        print(f"compare {kernel} {name}: N={shape[0]} T={shape[1]} max|Δ| params={err:.3g} "
              f"r2={err_r2:.3g} converged agree={agree:.4f}")

    rs = np.random.RandomState(1)
    for name, x, Y, p0, kw in mono_small_cases(rs):
        y = torch.from_numpy(Y).to(dev)
        run("monoexp_lm", name, monoexp_lm, monoexp_lm_reference, (x, y, p0), kw, Y.shape)
    rs = np.random.RandomState(2)
    for i, (name, x, Y, p0, kw) in enumerate(biexp_small_cases(rs)):
        y = torch.from_numpy(Y).to(dev)
        if i % 2:  # every other case in the (T, N) layout the fitters use
            y, kw = y.T.contiguous(), dict(kw, y_layout="tn")
        run("biexp_lm", name, biexp_lm, biexp_lm_reference, (x, y, p0), kw, Y.shape)
    rs = np.random.RandomState(3)
    for i, (name, model, x, Y, p0, kw) in enumerate(generic_small_cases(rs)):
        program = compile_model(model, p0.shape[-1])
        y = torch.from_numpy(Y).to(dev)
        if i % 2:
            y, kw = y.T.contiguous(), dict(kw, y_layout="tn")
        run("generic_lm", name, generic_lm, generic_lm_reference, (program, x, y, p0), kw,
            Y.shape)
    worst["warp_grid"] = warp_small(dev)
    return worst


# ----------------------------------------------------------------------
# Phase 4: monoexponential relaxometry at full size
# ----------------------------------------------------------------------
def config1_data(seed=0):
    """Bench config1 (bench.py:120-224): 512x512x64 voxels, 4 echoes at
    x = [10, 20, 30, 40], b = -1/(U*70+10), additive noise sigma 0.005.

    Returns (Y (N, T) f32, echo volumes (4 arrays of SHAPE), labels (SHAPE,
    uint8) with two regions covering 66% of the voxels).
    """
    N = int(np.prod(SHAPE))
    T = ECHO_TIMES.size
    rs = np.random.RandomState(seed)
    b_true = -1 / (rs.rand(N).astype(np.float32) * 70 + 10)
    Y = np.exp(b_true[:, None] * ECHO_TIMES[None, :]) + NOISE_SIGMA * rs.randn(N, T)
    Y = Y.astype(np.float32)
    echoes = [np.ascontiguousarray(Y[:, t]).reshape(SHAPE) for t in range(T)]
    labels_np = np.zeros(SHAPE, np.uint8)
    labels_np[32:480, 32:480, :32] = 1
    labels_np[64:448, 64:448, 32:] = 2
    return Y, echoes, labels_np


def phase_monoexp(dt, dev, card):
    from dosma_tpu_torch.ops.monoexp import (
        _packed_kernel, _packed_reference, monoexp_lm, monoexp_lm_reference,
    )

    N = int(np.prod(SHAPE))
    T = ECHO_TIMES.size
    t0 = time.perf_counter()
    Y, echoes, labels_np = config1_data(seed=0)
    print(f"phase 4 data: {N} voxels x {T} echoes made in {time.perf_counter() - t0:.2f} s (host)")

    affine = dt.to_affine(dt.SAGITTAL, spacing=(0.3125, 0.3125, 1.5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys = [dt.MedicalVolume(e, affine).to("cuda:0") for e in echoes]
    mask = dt.MedicalVolume(labels_np, affine).to("cuda:0")
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    labels = {1: "region_1", 2: "region_2"}

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tc_map, r2_map = dt.MonoExponentialFit(bounds=(0, 100), tc0="polyfit").fit(
        ECHO_TIMES, ys, mask=mask
    )
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = dt.T2(tc_map).metric_rows(mask, labels)
    metrics_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["monoexp_lm"]

    expect_launches("monoexp", monoexp_lm=1)
    check(isinstance(tc_map.A, torch.Tensor) and tc_map.A.is_cuda, "tc map is not on the card")
    check(tc_map.shape == SHAPE and r2_map.shape == SHAPE, f"map shape {tc_map.shape}")
    check(bool(torch.isfinite(tc_map.A).all()), "tc map has non-finite values")
    inside = mask.A > 0
    kept = float(((tc_map.A > 0) & inside).sum()) / float(inside.sum())
    print(f"main path: MonoExponentialFit.fit on {N} voxels: {fit_s:.4f} s "
          f"({N / fit_s:.4g} voxels/s, first run); H2D of echoes + mask {h2d_s:.4f} s; "
          f"metrics {metrics_s:.4f} s; kernel launches {launches}; "
          f"masked voxels with a kept tc: {kept:.5f}")
    for row in rows:
        print("  metrics:", json.dumps(row))
    check(kept > 0.95, f"only {kept:.4f} of masked voxels kept a tc")
    check(all(r["# Voxels"] > 0 and np.isfinite(r["Mean"]) for r in rows), "metric rows")

    # scipy parity of the main path's map on a subsample of masked voxels.
    import scipy.optimize as sop

    flat_inside = np.flatnonzero(labels_np.reshape(-1) > 0)
    idx = np.random.RandomState(2).choice(flat_inside, PARITY_N, replace=False)
    ours = tc_map.A.reshape(-1)[torch.from_numpy(idx).to(dev)].cpu().numpy().astype(np.float64)
    ref = np.empty(PARITY_N)
    for j, i in enumerate(idx):
        pb = sop.curve_fit(lambda t, a, bb: a * np.exp(bb * t), np.float64(ECHO_TIMES),
                           np.float64(Y[i]), p0=(1.0, -1 / 30), maxfev=500)[0]
        ref[j] = -1.0 / pb[1]
    use = ours > 0
    check(use.mean() > 0.95, f"parity subsample: only {use.mean():.4f} voxels kept")
    parity = float(np.sqrt(np.mean(((ours[use] - ref[use]) / ref[use]) ** 2)))
    print(f"scipy parity (map, rounded to 0.1): rel RMSE of tc {parity:.6g} over "
          f"{int(use.sum())} voxels (gate {PARITY_GATE})")
    check(parity < PARITY_GATE, f"scipy parity rel RMSE {parity}")

    # Kernel vs plain version at the main path's shape, through the wrappers
    # (NaN policy applied) and on the raw packed rows [a, b, r2, converged]
    # (r2 of every voxel, before the NaN policy zeroes any), then their times.
    yT = torch.stack([v.A.reshape(-1) for v in ys], dim=0)
    x_dev = torch.from_numpy(ECHO_TIMES).to(dev)
    args = (x_dev, yT, None, 100, 1e-5, 1e-5, True)
    got = monoexp_lm(ECHO_TIMES, yT, None, max_iter=100, y_layout="tn")
    ref_out = monoexp_lm_reference(ECHO_TIMES, yT, None, max_iter=100, y_layout="tn")
    torch.cuda.synchronize()
    max_err, max_err_r2, agree = compare("monoexp_lm full_size", got, ref_out)
    conv_frac = float(got[2].float().mean())
    raw_b = got[0][torch.from_numpy(idx).to(dev), 1].cpu().numpy().astype(np.float64)
    del got, ref_out
    pk, pr = _packed_kernel(*args), _packed_reference(*args)
    torch.cuda.synchronize()
    raw_err, raw_err_r2, raw_agree = compare_packed("monoexp_lm full_size_packed", pk, pr, 2)
    max_err, max_err_r2 = max(max_err, raw_err), max(max_err_r2, raw_err_r2)
    del pk, pr
    fin = np.isfinite(raw_b)
    raw_parity = float(np.sqrt(np.mean(((-1.0 / raw_b[fin] - ref[fin]) / ref[fin]) ** 2)))
    print(f"full size kernel vs plain: max|Δ| a,b={max_err:.3g} r2={max_err_r2:.3g} on every "
          f"voxel; converged agree {agree:.6f} (packed rows {raw_agree:.6f}); converged "
          f"fraction {conv_frac:.6f}; scipy parity of unrounded rates {raw_parity:.6g}")

    plain_ms, plain_all = time_ms(lambda: _packed_reference(*args))
    kernel_ms, kernel_all = time_ms(lambda: _packed_kernel(*args))
    metrics_ms, metrics_all = time_ms(lambda: dt.T2(tc_map).metric_rows(mask, labels))
    fit_ms, fit_all = time_ms(
        lambda: dt.MonoExponentialFit(bounds=(0, 100), tc0="polyfit").fit(ECHO_TIMES, ys, mask=mask)
    )
    print(f"times on {card}, {N} voxels x {T} echoes (median of 5 after a warm-up, CUDA events):")
    print(f"  kernel monoexp_lm: {kernel_ms:.4f} ms ({N / kernel_ms * 1e3:.6g} voxels/s) "
          f"runs {[round(t, 4) for t in kernel_all]}")
    print(f"  plain version:     {plain_ms:.4f} ms ({N / plain_ms * 1e3:.6g} voxels/s) "
          f"runs {[round(t, 4) for t in plain_all]}")
    print(f"  MonoExponentialFit.fit (warm): {fit_ms:.4f} ms ({N / fit_ms * 1e3:.6g} voxels/s) "
          f"runs {[round(t, 4) for t in fit_all]}")
    print(f"  T2.metric_rows (warm): {metrics_ms:.4f} ms runs {[round(t, 4) for t in metrics_all]}")
    b_ms, b_by = lm_bound(yT, 4, 20 * T + 40)
    return {"launches": launches, "max_abs_err": max(max_err, max_err_r2),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


# ----------------------------------------------------------------------
# Phases 5 and 6: the curve-fitting path at full width
# ----------------------------------------------------------------------
def biexp_data(seed=0):
    """bench.py:855-863: (N, 8) noiseless two-compartment decays."""
    N = int(np.prod(FIT_SHAPE))
    rs = np.random.RandomState(seed)
    a1 = 0.8 + 0.4 * rs.rand(N).astype(np.float32)
    b1 = -(0.4 + 0.2 * rs.rand(N).astype(np.float32))
    a2 = 0.3 + 0.3 * rs.rand(N).astype(np.float32)
    b2 = -(0.03 + 0.03 * rs.rand(N).astype(np.float32))
    x = BIEXP_X
    return (a1[:, None] * np.exp(b1[:, None] * x) + a2[:, None] * np.exp(b2[:, None] * x)
            ).astype(np.float32)


def generic_data(seed=0):
    """bench.py:900-908: (N, 5) noiseless offset exponentials, and the true b."""
    N = int(np.prod(FIT_SHAPE))
    rs = np.random.RandomState(seed)
    a = 0.5 + rs.rand(N).astype(np.float32)
    b = -1 / (rs.rand(N).astype(np.float32) * 70 + 10)
    c = 0.2 * rs.rand(N).astype(np.float32)
    x = GENERIC_X
    return (a[:, None] * np.exp(b[:, None] * x) + c[:, None]).astype(np.float32), b


def phase_biexp(dt, dev, card):
    from dosma_tpu_torch.ops.biexp import _packed_kernel, _reference_rows, biexp_lm, biexp_lm_reference

    N, T = int(np.prod(FIT_SHAPE)), BIEXP_X.size
    t0 = time.perf_counter()
    Y = biexp_data()
    print(f"phase 5 data: {N} voxels x {T} echoes made in {time.perf_counter() - t0:.2f} s (host)")
    affine = dt.to_affine(dt.SAGITTAL, spacing=(0.3125, 0.3125, 3.0))
    ys = [dt.MedicalVolume(np.ascontiguousarray(Y[:, t]).reshape(FIT_SHAPE), affine).to("cuda:0")
          for t in range(T)]
    fitter = dt.CurveFitter(dt.biexponential, p0=BIEXP_P0, r2_threshold=None)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    popt_map, r2_map = fitter.fit(BIEXP_X, ys)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = expect_launches("biexp", biexp_lm=1)
    check(isinstance(popt_map.A, torch.Tensor) and popt_map.A.is_cuda
          and isinstance(r2_map.A, torch.Tensor) and r2_map.A.is_cuda, "maps left the card")
    check(popt_map.shape == FIT_SHAPE + (4,) and r2_map.shape == FIT_SHAPE,
          f"map shapes {popt_map.shape}, {r2_map.shape}")
    popt_flat = popt_map.A.reshape(-1, 4)
    finite = float(torch.isfinite(popt_flat).all(1).float().mean())
    r2_min = float(r2_map.A.min())
    print(f"phase 5: CurveFitter(biexponential).fit on {N} voxels: {fit_s:.4f} s (first run); "
          f"launches {counts}; finite voxels {finite:.6f}; min r2 {r2_min:.6f}; voxels with "
          f"r2 < 0.999: {int((r2_map.A < 0.999).sum())} (noiseless data)")
    check(finite > 0.999 and r2_min > 0.99, "biexp maps: non-finite voxels or a poor fit")

    idx = np.random.RandomState(2).choice(N, PARITY_N, replace=False)
    parity = scipy_parity("biexp", lambda t, a1, b1, a2, b2: a1 * np.exp(b1 * t) + a2 * np.exp(b2 * t),
                          BIEXP_X, Y, popt_flat, idx, BIEXP_P0)

    yT = torch.stack([v.A.reshape(-1) for v in ys], dim=0)
    got = biexp_lm(BIEXP_X, yT, BIEXP_P0, max_iter=100, y_layout="tn")
    ref = biexp_lm_reference(BIEXP_X, yT, BIEXP_P0, max_iter=100, y_layout="tn")
    torch.cuda.synchronize()
    err, err_r2, agree = compare("biexp_lm full_size", got, ref)
    conv_frac = float(got[2].float().mean())
    del got, ref
    x_dev = torch.from_numpy(BIEXP_X).to(dev)
    p0_dev = torch.tensor(BIEXP_P0, dtype=torch.float32, device=dev)
    args = (x_dev, yT, p0_dev, 100, 1e-5, 1e-5)
    pk, pr = _packed_kernel(*args), _reference_rows(*args)
    torch.cuda.synchronize()
    raw_err, raw_err_r2, raw_agree = compare_packed("biexp_lm full_size_packed", pk, pr, 4)
    del pk, pr
    err, err_r2 = max(err, raw_err), max(err_r2, raw_err_r2)
    print(f"phase 5 kernel vs plain: max|Δ| params={err:.3g} r2={err_r2:.3g} on every voxel; "
          f"converged agree {agree:.6f} (packed rows {raw_agree:.6f}); converged fraction "
          f"{conv_frac:.6f}")
    check(conv_frac > 0.999, f"biexp converged fraction {conv_frac}")

    plain_ms, plain_all = time_ms(lambda: _reference_rows(*args))
    kernel_ms, kernel_all = time_ms(lambda: _packed_kernel(*args))
    fit_ms, fit_all = time_ms(lambda: fitter.fit(BIEXP_X, ys))
    print(f"times on {card}, {N} voxels x {T} echoes (median of 5 after a warm-up, CUDA events):")
    print(f"  kernel biexp_lm: {kernel_ms:.4f} ms ({N / kernel_ms * 1e3:.6g} voxels/s) "
          f"runs {[round(t, 4) for t in kernel_all]}")
    print(f"  plain version:   {plain_ms:.4f} ms runs {[round(t, 4) for t in plain_all]}")
    print(f"  CurveFitter(biexponential).fit (warm): {fit_ms:.4f} ms "
          f"({N / fit_ms * 1e3:.6g} voxels/s) runs {[round(t, 4) for t in fit_all]}")
    b_ms, b_by = lm_bound(yT, 6, 40 * T + 80)
    return {"launches": counts["biexp_lm"], "max_abs_err": max(err, err_r2), "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "fit_ms": fit_ms, "scipy_parity": parity, "converged_fraction": conv_frac}


def phase_generic(dt, dev, card):
    from dosma_tpu_torch.ops.generic_lm import (
        _packed_kernel, _reference_rows, compile_model, generic_lm, generic_lm_reference,
    )
    from dosma_tpu_torch.ops.nlls import lm_fit

    N, T = int(np.prod(FIT_SHAPE)), GENERIC_X.size
    t0 = time.perf_counter()
    Y, b_true = generic_data()
    print(f"phase 6 data: {N} voxels x {T} points made in {time.perf_counter() - t0:.2f} s (host)")
    yT = torch.from_numpy(np.ascontiguousarray(Y.T)).to(dev)

    def fit():
        return dt.curve_fit(offset_exp, GENERIC_X, yT, p0=GENERIC_P0, maxfev=60)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    popt, r2 = fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = expect_launches("generic", generic_lm=1)
    check(popt.is_cuda and r2.is_cuda and tuple(popt.shape) == (N, 3), "curve_fit output")
    finite = float(torch.isfinite(popt).all(1).float().mean())
    b_err = (popt[:, 1] - torch.from_numpy(b_true).to(dev)).abs().nan_to_num(0)
    print(f"phase 6: curve_fit(offset_exp) on {N} voxels: {fit_s:.4f} s (first run); launches "
          f"{counts}; finite voxels {finite:.6f}; max |b - b_true| {float(b_err.max()):.3g}; "
          f"voxels with |b - b_true| > 1e-3: {int((b_err > 1e-3).sum())}, with r2 < 0.999: "
          f"{int((r2 < 0.999).sum())} (noiseless data)")
    check(finite > 0.999, "generic fit: non-finite voxels")

    idx = np.random.RandomState(2).choice(N, PARITY_N, replace=False)
    parity = scipy_parity("offset_exp", lambda t, a, b, c: a * np.exp(b * t) + c,
                          GENERIC_X, Y, popt, idx, GENERIC_P0)

    program = compile_model(offset_exp, 3)
    got = generic_lm(program, GENERIC_X, yT, GENERIC_P0, max_iter=60, y_layout="tn")
    ref = generic_lm_reference(program, GENERIC_X, yT, GENERIC_P0, max_iter=60, y_layout="tn")
    torch.cuda.synchronize()
    err, err_r2, agree = compare("generic_lm full_size", got, ref)
    conv_frac = float(got[2].float().mean())
    del got, ref
    x_dev = torch.from_numpy(GENERIC_X).to(dev)
    p0_dev = torch.tensor(GENERIC_P0, dtype=torch.float32, device=dev)
    args = (program, x_dev, yT, p0_dev, 60, 1e-5, 1e-5)
    pk, pr = _packed_kernel(*args), _reference_rows(*args)
    torch.cuda.synchronize()
    raw_err, raw_err_r2, raw_agree = compare_packed("generic_lm full_size_packed", pk, pr, 3)
    del pk, pr
    err, err_r2 = max(err, raw_err), max(err_r2, raw_err_r2)
    print(f"phase 6 kernel vs plain: max|Δ| params={err:.3g} r2={err_r2:.3g} on every voxel; "
          f"converged agree {agree:.6f} (packed rows {raw_agree:.6f}); converged fraction "
          f"{conv_frac:.6f}")
    check(conv_frac > 0.999, f"generic converged fraction {conv_frac}")

    def model_fn(xc, ps):
        return offset_exp(xc, *ps)

    yNT = yT.T
    plain_ms, plain_all = time_ms(lambda: _reference_rows(*args))
    lm_ms, lm_all = time_ms(lambda: lm_fit(model_fn, GENERIC_X, yNT, p0_dev, max_iter=60))
    kernel_ms, kernel_all = time_ms(lambda: _packed_kernel(*args))
    fit_ms, fit_all = time_ms(fit)
    print(f"times on {card}, {N} voxels x {T} points (median of 5 after a warm-up, CUDA events):")
    print(f"  kernel generic_lm: {kernel_ms:.4f} ms ({N / kernel_ms * 1e3:.6g} voxels/s) "
          f"runs {[round(t, 4) for t in kernel_all]}")
    print(f"  plain version:     {plain_ms:.4f} ms runs {[round(t, 4) for t in plain_all]}")
    print(f"  lm_fit (torch.func.jvp engine): {lm_ms:.4f} ms runs {[round(t, 4) for t in lm_all]}"
          f"; lm_fit / kernel {lm_ms / kernel_ms:.4g}")
    print(f"  curve_fit (warm): {fit_ms:.4f} ms ({N / fit_ms * 1e3:.6g} voxels/s) "
          f"runs {[round(t, 4) for t in fit_all]}")
    b_ms, b_by = lm_bound(yT, 5, 30 * T + 50)
    return {"launches": counts["generic_lm"], "max_abs_err": max(err, err_r2), "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "lm_fit_ms": lm_ms, "fit_ms": fit_ms, "scipy_parity": parity,
            "converged_fraction": conv_frac}


# ----------------------------------------------------------------------
# Phase 7: matrix registration at full width
# ----------------------------------------------------------------------
def registration_phantom():
    """bench.py:650-659: a bright box plus noise; moving = fixed rolled."""
    rs = np.random.RandomState(5)
    s = REG_SHAPE
    fixed = np.zeros(s, np.float32)
    fixed[s[0] // 4: -s[0] // 4, s[1] // 4: -s[1] // 4, 4:-4] = 1000.0
    fixed += 50.0 * rs.rand(*s).astype(np.float32)
    moving = np.roll(fixed, REG_SHIFT, axis=(0, 1, 2))
    return fixed, moving


def corner_error_vox(M_est):
    """Largest displacement error over the volume corners, in voxels of the
    index grid: the estimated fixed → moving index map against the known
    shift."""
    A = REG_AFFINE
    B_est = np.linalg.inv(A) @ np.asarray(M_est) @ A
    corners = np.array([[i, j, k, 1.0] for i in (0, REG_SHAPE[0] - 1)
                        for j in (0, REG_SHAPE[1] - 1) for k in (0, REG_SHAPE[2] - 1)]).T
    want = corners[:3] + np.asarray(REG_SHIFT, np.float64)[:, None]
    return float(np.linalg.norm((B_est @ corners)[:3] - want, axis=0).max())


def plain_warp_of(stack, tdata, order):
    """The plain version of the warp the registration path launched: the
    sources prepared from ``stack`` (NB, ...) on the card, B built from the
    written transform files as apply_warp builds it."""
    from dosma_tpu_torch.ops.registration import (
        _f32,
        _world_matrix_to_index_map,
        compose_transforms,
    )
    from dosma_tpu_torch.ops.warp import prepare_sources, warp_grid_reference

    dev = torch.device("cuda", 0)
    M = compose_transforms([np.asarray(t["matrix"]) for t in tdata])
    M[3] = (0.0, 0.0, 0.0, 1.0)  # the composition's float64 round-off below 1e-16
    B = _world_matrix_to_index_map(_f32(M, dev), _f32(tdata[0]["fixed_affine"], dev),
                                   _f32(REG_AFFINE, dev))
    srcs = prepare_sources(_f32(stack, dev), order)
    out = warp_grid_reference(srcs, B, tuple(tdata[0]["fixed_shape"]), order)
    torch.cuda.synchronize()
    return out, tuple(srcs.shape)


def phase_registration(dt, card):
    from dosma_tpu_torch.core.registration import _load_transform_file
    from dosma_tpu_torch.ops.registration import compose_transforms

    fixed, moving = registration_phantom()
    fv, mv = dt.MedicalVolume(fixed, REG_AFFINE), dt.MedicalVolume(moving, REG_AFFINE)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_reg_")
    try:
        def run():
            return dt.register(fv, mv, "affine", output_path=out_dir, save_volumes=False,
                               return_volumes=True)

        t0 = time.perf_counter()
        run()
        first_s = time.perf_counter() - t0
        walls = []
        for _ in range(3):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = expect_launches("register", warp_grid=1)
        warped = res["volumes"][0].A
        check(isinstance(warped, np.ndarray) and warped.shape == REG_SHAPE
              and np.isfinite(warped).all(), "register: warped volume is not a finite host array")
        tfile = res["outputs"][0].transform
        tdata = [_load_transform_file(t) for t in tfile]
        order = int(tdata[-1]["final_interp_order"])
        M = compose_transforms([np.asarray(t["matrix"]) for t in tdata])
        # The kernel's output against its plain version at the path's shapes.
        ref, src_shape = plain_warp_of(moving[None], tdata, order)
        got = torch.from_numpy(np.ascontiguousarray(warped)).to(ref.device)[None]
        err_reg, equal_reg = compare_warp("register's warp", got, ref)
        del got
        del ref
        print(f"compare warp_grid register order {order}: sources {src_shape} -> {REG_SHAPE} "
              f"max|Δ|={err_reg:.3g} bit-equal={equal_reg}")
        err = corner_error_vox(M)
        s = REG_SHAPE
        box = (slice(s[0] // 4, -s[0] // 4), slice(s[1] // 4, -s[1] // 4), slice(4, -4))
        rmse_before = float(np.sqrt(np.mean((moving[box] - fixed[box]) ** 2)))
        rmse_after = float(np.sqrt(np.mean((warped[box] - fixed[box]) ** 2)))
        print(f"phase 7: register(affine) on {s}: first call {first_s:.4f} s, warm "
              f"{[round(w, 4) for w in walls]} s (median {statistics.median(walls):.4f}); "
              f"launches in one warm call {counts}; corner error {err:.4f} voxel; "
              f"RMSE in the box {rmse_before:.4f} -> {rmse_after:.4f} "
              f"({rmse_before / rmse_after:.3g}x)")
        check(err < 0.5, f"registration recovery error {err} voxel")
        check(rmse_before >= 4 * rmse_after, f"RMSE fell only {rmse_before / rmse_after:.3g}x")

        vols4 = [moving * np.float32(1.0 + 0.1 * i) for i in range(4)]
        stack = [dt.MedicalVolume(v, REG_AFFINE) for v in vols4]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warped4 = dt.apply_warp(stack, transform=tfile)
        apply_s = time.perf_counter() - t0
        apply_counts = expect_launches("apply_warp", warp_grid=1)
        check(len(warped4) == 4, f"apply_warp returned {len(warped4)} volumes, not 4")
        ref, src_shape = plain_warp_of(np.stack(vols4), tdata, order)
        got = torch.from_numpy(np.stack([w.A for w in warped4])).to(ref.device)
        err_apply, equal_apply = compare_warp("apply_warp's stacked warp", got, ref)
        del got, ref
        print(f"compare warp_grid apply_warp order {order}: sources {src_shape} -> {REG_SHAPE} "
              f"max|Δ|={err_apply:.3g} bit-equal={equal_apply}")
        print(f"phase 7: apply_warp of 4 volumes: {apply_s:.4f} s, launches {apply_counts}")
        return {"launches": counts["warp_grid"], "apply_warp_launches": apply_counts["warp_grid"],
                "max_abs_err": max(err_reg, err_apply),
                "register_first_s": first_s, "register_warm_s": statistics.median(walls),
                "recovery_error_vox": err, "rmse_before": rmse_before, "rmse_after": rmse_after}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 8: the warp kernel at a knee scan's size
# ----------------------------------------------------------------------
def warp_work(srcs_shape, out_shape, nb, order):
    """(bytes, float32 operations) of one warp: each source read once, each
    output written once; the operations the function needs per output point,
    not the kernel's instruction mix. Both orders: 18 for the coordinate
    (3 rows of 3 products and 3 sums). Order 1: 9 for the per-axis fraction
    and its complement, 12 for the 8 corner weights, 16 a volume (8 products,
    8 sums). Order 3: 45 for the 3x4 B-spline weights in closed form (15 an
    axis), 80 for the 64 weight products (16 + 64), 128 a volume."""
    npts = int(np.prod(out_shape))
    nbytes = 4 * (int(np.prod(srcs_shape)) + nb * npts)
    per_point = (39 + 16 * nb) if order == 1 else (143 + 128 * nb)
    return nbytes, per_point * npts


def grid_sample_call(vols, B, out_shape):
    """F.grid_sample computing the order-1 warp (trilinear, zeros outside,
    align_corners=True): the library yardstick, never used by the port.
    Returns the call and its grid (normalized (x, y, z) = (k, j, i))."""
    import torch.nn.functional as F

    dev = vols.device
    axes = [torch.arange(d, dtype=torch.float32, device=dev) for d in out_shape]
    gi, gj, gk = torch.meshgrid(*axes, indexing="ij")
    c = [B[a, 0] * gi + B[a, 1] * gj + B[a, 2] * gk + B[a, 3] for a in range(3)]
    dims = vols.shape[1:]
    grid = torch.stack([c[2] * (2.0 / (dims[2] - 1)) - 1.0, c[1] * (2.0 / (dims[1] - 1)) - 1.0,
                        c[0] * (2.0 / (dims[0] - 1)) - 1.0], dim=-1)[None]
    inp = vols[None]

    def call():
        return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)[0]
    return call


def phase_warp(dev, card):
    from dosma_tpu_torch.ops.registration import _world_matrix_to_index_map
    from dosma_tpu_torch.ops.warp import prepare_sources, warp_grid, warp_grid_reference

    M = np.array([[np.cos(WARP_ANGLE), -np.sin(WARP_ANGLE), 0, WARP_SHIFT[0]],
                  [np.sin(WARP_ANGLE), np.cos(WARP_ANGLE), 0, WARP_SHIFT[1]],
                  [0, 0, 1.0, WARP_SHIFT[2]], [0, 0, 0, 1.0]], np.float32)
    A = torch.from_numpy(WARP_AFFINE.astype(np.float32)).to(dev)
    B = _world_matrix_to_index_map(torch.from_numpy(M).to(dev), A, A)[:3].contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    vols = torch.rand((KNEE_VOLUMES,) + KNEE_SHAPE, generator=gen, device=dev)
    out_shape = KNEE_SHAPE
    res = {}
    worst = 0.0
    print(f"phase 8 on {card}, {KNEE_VOLUMES} x {KNEE_SHAPE} f32 (CUDA events, median of 5):")
    for order in (1, 3):
        srcs = prepare_sources(vols, order)
        got = warp_grid(srcs, B, out_shape, order)
        ref = warp_grid_reference(srcs, B, out_shape, order)
        torch.cuda.synchronize()
        err, equal = compare_warp(f"warp_grid knee order {order}", got, ref)
        worst = max(worst, err)
        del got, ref
        kernel_ms, kernel_all = time_ms(lambda: warp_grid(srcs, B, out_shape, order))
        plain_ms, plain_all = time_ms(lambda: warp_grid_reference(srcs, B, out_shape, order))
        nbytes, flops = warp_work(tuple(srcs.shape), out_shape, KNEE_VOLUMES, order)
        b_ms, b_by = bound(nbytes, flops)
        entry = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "bytes": nbytes, "flops": flops, "max_abs_err": err, "bit_equal": equal}
        line = (f"  order {order}: kernel {kernel_ms:.4f} ms runs {[round(t, 4) for t in kernel_all]}"
                f"; plain {plain_ms:.4f} ms; {nbytes / 1e6:.1f} MB, "
                f"{nbytes / kernel_ms / 1e9:.4g} TB/s achieved; bound {b_ms:.4f} ms by {b_by} "
                f"({b_ms / kernel_ms:.3g} of it); max|Δ| {err:.3g}, bit-equal {equal}")
        if order == 3:
            pre_ms, pre_all = time_ms(lambda: prepare_sources(vols, 3))
            entry["prefilter_ms"] = pre_ms
            line += f"; prefilter alone {pre_ms:.4f} ms"
        else:
            call = grid_sample_call(vols, B, out_shape)
            gs = call()
            ours = warp_grid(srcs, B, out_shape, 1)
            gs_diff = float((gs - ours).abs().max())
            del gs, ours
            gs_ms, gs_all = time_ms(call)
            entry["grid_sample_ms"] = gs_ms
            entry["grid_sample_max_abs_diff"] = gs_diff
            line += f"; F.grid_sample {gs_ms:.4f} ms (max |Δ| to the kernel {gs_diff:.3g})"
            del call
        del srcs
        torch.cuda.empty_cache()
        res[order] = entry
        print(line)

    # bench.py's warp row: one 192x192x48 volume, order 1.
    gen = torch.Generator(device=dev).manual_seed(3)
    vol = torch.rand((1,) + REG_SHAPE, generator=gen, device=dev)
    bench_ms, bench_all = time_ms(lambda: warp_grid(vol, B, REG_SHAPE, 1))
    n = int(np.prod(REG_SHAPE))
    print(f"  bench size {REG_SHAPE}, one volume, order 1: {bench_ms:.4f} ms "
          f"({n / bench_ms / 1e3:.4g} Mpts/s) runs {[round(t, 4) for t in bench_all]}")
    res["bench_ms"] = bench_ms
    res["max_abs_err"] = worst
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="stop after phase 3 (build and small cases); prints no result")
    opts = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required",
              file=sys.stderr)
        return 1

    # Phase 1: the card.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    # TF32 off: float32 products (the registration's world coordinates and
    # joint histograms) and convolutions run in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dosma_tpu_torch as dt

    build_all()  # phase 2
    worst = small_cases(dev)  # phase 3
    if opts.quick:
        print(f"quick run: small cases agree, worst |Δ| {worst}")
        return 0

    t_start = time.perf_counter()
    mono = phase_monoexp(dt, dev, card)
    torch.cuda.empty_cache()
    biexp = phase_biexp(dt, dev, card)
    torch.cuda.empty_cache()
    generic = phase_generic(dt, dev, card)
    torch.cuda.empty_cache()
    print(f"phases 4-6: {time.perf_counter() - t_start:.1f} s")
    t_start = time.perf_counter()
    reg = phase_registration(dt, card)
    torch.cuda.empty_cache()
    knee = phase_warp(dev, card)
    print(f"phases 7-8: {time.perf_counter() - t_start:.1f} s")
    # warp_grid's entry: order 1 at the knee size (F.grid_sample computes the
    # same function: the library yardstick), order 3 beside it, the launches
    # of one warm register call (phase 7).
    o1, o3 = knee[1], knee[3]
    warp = {"launches": reg["launches"], "max_abs_err": knee["max_abs_err"],
            "ms": o1["ms"], "plain_ms": o1["plain_ms"], "bound_ms": o1["bound_ms"],
            "bound_by": o1["bound_by"], "library_ms": o1["grid_sample_ms"],
            "grid_sample_ms": o1["grid_sample_ms"], "shape": [KNEE_VOLUMES, *KNEE_SHAPE],
            "order3": {k: o3[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "prefilter_ms")},
            "bench_192x192x48_order1_ms": knee["bench_ms"],
            **{k: v for k, v in reg.items() if k not in ("launches", "max_abs_err")}}
    warp["max_abs_err"] = max(warp["max_abs_err"], reg["max_abs_err"])

    sources = {
        "monoexp_lm": ("dosma_tpu_torch/csrc/monoexp_lm.cu", "dosma_tpu/ops/monoexp_pallas.py:92"),
        "biexp_lm": ("dosma_tpu_torch/csrc/biexp_lm.cu", "dosma_tpu/ops/biexp_pallas.py:83"),
        "generic_lm": ("dosma_tpu_torch/csrc/generic_lm.cuh",
                       "dosma_tpu/ops/generic_lm_pallas.py:52"),
        "warp_grid": ("dosma_tpu_torch/csrc/warp_grid.cu", "dosma_tpu/ops/warp_pallas.py:116"),
    }
    kernels = []
    for name, res in (("monoexp_lm", mono), ("biexp_lm", biexp), ("generic_lm", generic),
                      ("warp_grid", warp)):
        source, replaces = sources[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": res["launches"],
                 "max_abs_err": max(res["max_abs_err"], worst[name]),
                 "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                 "bound_by": res["bound_by"], "library_ms": res["library_ms"]}
        entry.update({k: v for k, v in res.items() if k not in entry and k != "max_abs_err"})
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
