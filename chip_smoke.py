#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card, and check it.

Usage, from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the monoexponential fit kernel from dosma_tpu_torch/csrc/;
  3. hold the kernel against its plain PyTorch version on the card at small
     shapes: edge cases, T in {2, 3, 4, 8, 11}, uniform and non-uniform echo
     times. Tolerance: |Δ| <= 1e-5 * max(1, |v|) on a, b and r2 on every
     voxel, identical NaN positions, converged flags equal on >= 99.9% of
     voxels;
  4. the main path at full size: four 512x512x64 echo volumes on the card
     (16.7M voxels, noisy monoexponential data made from seed 0) through
     MonoExponentialFit(bounds=(0, 100), tc0="polyfit").fit and the T2
     map's regional metrics; the kernel's launch count over that run; scipy
     parity of the map on a 2,000-voxel subsample (relative RMSE of tc
     < 5e-3); kernel and plain version compared at full size with the same
     tolerance (every voxel, r2 included), and timed with CUDA events
     (median of 5 after a warm-up).
The last two lines are one JSON object per kernel and the result object.
It imports nothing of JAX.
"""

import json
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


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def compare(name, got, ref):
    """Kernel vs plain outputs (popt (N, 2), r2 (N,), converged (N,)).

    a, b and r2 each agree within TOL * max(1, |v|) on every voxel, with
    identical NaN and infinity positions; converged flags agree on at least
    CONV_AGREE of the voxels. Returns (max |Δ| on a and b, max |Δ| on r2,
    converged agreement).
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
    err_ab, err_r2 = float(col_err[:2].max()), float(col_err[2])
    agree = float((ck == cr).float().mean())
    check(int(outside.sum()) == 0,
          f"{name}: voxels outside tolerance (a, b, r2) {outside.tolist()}, "
          f"max |Δ| {col_err.tolist()}")
    check(agree >= CONV_AGREE, f"{name}: converged flags agree on only {agree:.5f}")
    return err_ab, err_r2, agree


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


def small_cases(rs):
    """(name, x, y (N, T), p0, kwargs) edge cases at small shapes."""
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


def main():
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
    from dosma_tpu_torch.ops import _build
    from dosma_tpu_torch.ops.monoexp import (
        _packed_kernel, _packed_reference, monoexp_lm, monoexp_lm_reference,
    )

    # Phase 2: build.
    t0 = time.perf_counter()
    lib = _build.load_library("monoexp_lm")
    print(f"build: monoexp_lm.cu in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s)")
    for line in lib.build_log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # Phase 3: kernel vs plain version at small shapes.
    rs = np.random.RandomState(1)
    for name, x, Y, p0, kw in small_cases(rs):
        y = torch.from_numpy(Y).to(dev)
        got = monoexp_lm(x, y, p0, **kw)
        torch.cuda.synchronize()
        ref = monoexp_lm_reference(x, y, p0, **kw)
        torch.cuda.synchronize()
        err, err_r2, agree = compare(name, got, ref)
        print(f"compare {name}: N={Y.shape[0]} T={Y.shape[1]} max|Δ| a,b={err:.3g} "
              f"r2={err_r2:.3g} converged agree={agree:.4f}")

    # Phase 4: the main path at full size.
    N = int(np.prod(SHAPE))
    T = ECHO_TIMES.size
    t0 = time.perf_counter()
    Y, echoes, labels_np = config1_data(seed=0)
    print(f"data: {N} voxels x {T} echoes made in {time.perf_counter() - t0:.2f} s (host)")

    affine = dt.to_affine(dt.SAGITTAL, spacing=(0.3125, 0.3125, 1.5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys = [dt.MedicalVolume(e, affine).to("cuda:0") for e in echoes]
    mask = dt.MedicalVolume(labels_np, affine).to("cuda:0")
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    labels = {1: "region_1", 2: "region_2"}

    monoexp_lm.launches = 0
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
    launches = monoexp_lm.launches

    check(launches == 1, f"the main path launched the kernel {launches} times, not once")
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
    max_err, max_err_r2, agree = compare("full_size", got, ref_out)
    conv_frac = float(got[2].float().mean())
    raw_b = got[0][torch.from_numpy(idx).to(dev), 1].cpu().numpy().astype(np.float64)
    del got, ref_out
    pk, pr = _packed_kernel(*args), _packed_reference(*args)
    torch.cuda.synchronize()
    raw_err, raw_err_r2, raw_agree = compare(
        "full_size_packed", (pk[:2].T, pk[2], pk[3]), (pr[:2].T, pr[2], pr[3])
    )
    max_err, max_err_r2 = max(max_err, raw_err), max(max_err_r2, raw_err_r2)
    del pk, pr
    fin = np.isfinite(raw_b)
    raw_parity = float(np.sqrt(np.mean(((-1.0 / raw_b[fin] - ref[fin]) / ref[fin]) ** 2)))
    print(f"full size kernel vs plain: max|Δ| a,b={max_err:.3g} r2={max_err_r2:.3g} on every "
          f"voxel; converged agree {agree:.6f} (packed rows {raw_agree:.6f}); converged "
          f"fraction {conv_frac:.6f}; scipy parity of unrounded rates {raw_parity:.6g}")

    def time_ms(fn, reps=5):
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

    print(card)
    print(json.dumps({"kernels": [{
        "name": "monoexp_lm",
        "route": "cuda",
        "source": "dosma_tpu_torch/csrc/monoexp_lm.cu",
        "replaces": "dosma_tpu/ops/monoexp_pallas.py:92",
        "launches": launches,
        "max_abs_err": max_err,
        "max_abs_err_r2": max_err_r2,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
