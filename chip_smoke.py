#!/usr/bin/env python3
"""Drive the PyTorch port's fitting paths once on a CUDA card, and check them.

Usage, from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --quick    # phases 1-3 only: build, small cases

Phases (any failure raises and exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build every kernel from dosma_tpu_torch/csrc/, one nvcc process per
     source, all started together: monoexp_lm.cu, biexp_lm.cu and the
     generic LM kernel generated for each model used below; print the nvcc
     seconds and the ptxas register and spill counts;
  3. hold each kernel against its plain PyTorch version on the card at
     small shapes: edge cases (all-zero voxel, y_bounds, nan_policy="keep"
     with one iteration, N not a multiple of the block, per-voxel p0, a
     seed whose cost is inf), several T, and for the generic kernel models
     with P = 1, 2, 3, 4 built from every whitelisted operation.
     Tolerance: |Δ| <= 1e-5 * max(1, |v|) on every parameter and r2 of
     every voxel, identical NaN and infinity positions, converged flags
     equal on >= 99.9% of voxels;
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
     same data.
Each path (phases 4, 5, 6) runs with every launch count set to 0 just
before it and read just after. The last two lines are one JSON object
with every kernel and the result object. It imports nothing of JAX.
"""

import argparse
import concurrent.futures
import json
import re
import statistics
import subprocess
import sys
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


def reset_launches():
    from dosma_tpu_torch.ops.biexp import biexp_lm
    from dosma_tpu_torch.ops.generic_lm import generic_lm
    from dosma_tpu_torch.ops.monoexp import monoexp_lm

    for fn in (monoexp_lm, biexp_lm, generic_lm):
        fn.launches = 0


def launch_counts():
    from dosma_tpu_torch.ops.biexp import biexp_lm
    from dosma_tpu_torch.ops.generic_lm import generic_lm
    from dosma_tpu_torch.ops.monoexp import monoexp_lm

    return {"monoexp_lm": monoexp_lm.launches, "biexp_lm": biexp_lm.launches,
            "generic_lm": generic_lm.launches}


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
            "biexp_lm.cu": lambda: _build.load_library("biexp_lm")}
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


def small_cases(dev):
    """Phase 3: every kernel against its plain version. Returns the
    largest |Δ| on parameters and r2 for each kernel."""
    from dosma_tpu_torch.ops.biexp import biexp_lm, biexp_lm_reference
    from dosma_tpu_torch.ops.generic_lm import compile_model, generic_lm, generic_lm_reference
    from dosma_tpu_torch.ops.monoexp import monoexp_lm, monoexp_lm_reference

    worst = {"monoexp_lm": 0.0, "biexp_lm": 0.0, "generic_lm": 0.0}

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

    check(counts == {"monoexp_lm": 1, "biexp_lm": 0, "generic_lm": 0},
          f"the monoexp path launched {counts}, not monoexp_lm once")
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
    return {"launches": launches, "max_abs_err": max(max_err, max_err_r2),
            "ms": kernel_ms, "plain_ms": plain_ms}


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
    counts = launch_counts()
    check(counts == {"monoexp_lm": 0, "biexp_lm": 1, "generic_lm": 0},
          f"the biexp path launched {counts}, not biexp_lm once")
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
    return {"launches": counts["biexp_lm"], "max_abs_err": max(err, err_r2), "ms": kernel_ms,
            "plain_ms": plain_ms, "fit_ms": fit_ms, "scipy_parity": parity,
            "converged_fraction": conv_frac}


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
    counts = launch_counts()
    check(counts == {"monoexp_lm": 0, "biexp_lm": 0, "generic_lm": 1},
          f"the generic path launched {counts}, not generic_lm once")
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
    return {"launches": counts["generic_lm"], "max_abs_err": max(err, err_r2), "ms": kernel_ms,
            "plain_ms": plain_ms, "lm_fit_ms": lm_ms, "fit_ms": fit_ms, "scipy_parity": parity,
            "converged_fraction": conv_frac}


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
    print(f"phases 4-6: {time.perf_counter() - t_start:.1f} s")

    sources = {
        "monoexp_lm": ("dosma_tpu_torch/csrc/monoexp_lm.cu", "dosma_tpu/ops/monoexp_pallas.py:92"),
        "biexp_lm": ("dosma_tpu_torch/csrc/biexp_lm.cu", "dosma_tpu/ops/biexp_pallas.py:83"),
        "generic_lm": ("dosma_tpu_torch/csrc/generic_lm.cuh",
                       "dosma_tpu/ops/generic_lm_pallas.py:52"),
    }
    kernels = []
    for name, res in (("monoexp_lm", mono), ("biexp_lm", biexp), ("generic_lm", generic)):
        source, replaces = sources[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": res["launches"],
                 "max_abs_err": max(res["max_abs_err"], worst[name]),
                 "ms": res["ms"], "plain_ms": res["plain_ms"]}
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
