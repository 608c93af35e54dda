#!/usr/bin/env python3
"""Where the time of the port's main path goes on a CUDA card.

Usage, from the repository root on a machine with one CUDA card:

    python3 tools/profile_monoexp_fit.py [--reps 3] [--out FILE]

At bench config1 (512x512x64 voxels x 4 echoes, seed 0, the data of
``chip_smoke.config1_data``), after a warm-up, it measures:
  1. ``MonoExponentialFit(bounds=(0, 100), tc0="polyfit").fit`` with the
     echoes on the card: host wall per fit (median, no profiler), then
     ``torch.profiler`` over ``--reps`` fits — per-op CUDA self times,
     device busy time per fit (the sum of all kernel and copy times) and
     the device's idle share (1 - busy / wall);
  2. ``T2(tc_map).metric_rows(mask, labels)``: the same;
  3. host-to-card copy of the four echo volumes (268 MB), pageable and
     pinned (median of 3);
  4. the fit kernel built without (the default) and with fused
     multiply-adds, timed with CUDA events in the order nofma, fma, fma,
     nofma (median of 7 each), and how far the two builds' rates differ.
Every section prints the card's name and power limit. With ``--out`` the
whole report is also written to FILE. It imports nothing of JAX.
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _median_wall_s(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def _events_ms(fn, reps):
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


def _profile(name, fn, reps, say):
    from torch.profiler import ProfilerActivity, profile

    fn()
    wall_s, walls = _median_wall_s(fn, max(reps, 5))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy_ms = busy_us / 1e3 / reps
    say(f"[{name}] host wall per call, no profiler: median {wall_s * 1e3:.4f} ms "
        f"runs {[round(t * 1e3, 4) for t in walls]}")
    say(f"[{name}] device busy per call (profiler, {reps} calls): {busy_ms:.4f} ms; "
        f"idle share of the wall {1 - busy_ms / (wall_s * 1e3):.4f}")
    say(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=16))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3, help="calls under the profiler")
    ap.add_argument("--out", type=Path, default=None, help="also write the report here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_monoexp_fit: a CUDA card is required", file=sys.stderr)
        return 1

    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"card: {card}")

    import dosma_tpu_torch as dt
    from chip_smoke import ECHO_TIMES, config1_data
    from dosma_tpu_torch.ops.monoexp import _packed_kernel

    dev = torch.device("cuda", 0)
    Y, echoes, labels_np = config1_data(seed=0)
    affine = dt.to_affine(dt.SAGITTAL, spacing=(0.3125, 0.3125, 1.5))
    ys = [dt.MedicalVolume(e, affine).to(dev) for e in echoes]
    mask = dt.MedicalVolume(labels_np, affine).to(dev)
    labels = {1: "region_1", 2: "region_2"}
    fitter = dt.MonoExponentialFit(bounds=(0, 100), tc0="polyfit")
    N = Y.shape[0]
    say(f"config1: {N} voxels x {ECHO_TIMES.size} echoes on {card}")

    # 1-2. The fit and the metrics.
    tc_map, _ = fitter.fit(ECHO_TIMES, ys, mask=mask)
    _profile("fit", lambda: fitter.fit(ECHO_TIMES, ys, mask=mask), args.reps, say)
    _profile("metric_rows", lambda: dt.T2(tc_map).metric_rows(mask, labels), args.reps, say)

    # 3. Host to card.
    stacked = np.ascontiguousarray(np.stack(echoes))
    pinned = torch.from_numpy(stacked).pin_memory()
    for label, src in (("pageable", torch.from_numpy(stacked)), ("pinned", pinned)):
        src.to(dev, non_blocking=True)
        med, runs = _median_wall_s(lambda: src.to(dev, non_blocking=True), 3)
        say(f"[h2d] {stacked.nbytes} bytes {label}: median {med * 1e3:.4f} ms "
            f"runs {[round(t * 1e3, 4) for t in runs]} on {card}")

    # 4. The kernel with and without fused multiply-adds.
    yT = torch.from_numpy(np.ascontiguousarray(Y.T)).to(dev)
    x_dev = torch.from_numpy(ECHO_TIMES).to(dev)
    kargs = (x_dev, yT, None, 100, 1e-5, 1e-5, True)
    outs, meds = {}, {"nofma": [], "fma": []}
    for label in ("nofma", "fma", "fma", "nofma"):
        fmad = label == "fma"
        outs[label] = _packed_kernel(*kargs, fmad=fmad)
        med, runs = _events_ms(lambda: _packed_kernel(*kargs, fmad=fmad), 7)
        meds[label].append(med)
        say(f"[fmad] {label}: median {med:.4f} ms runs {[round(t, 4) for t in runs]}")
    db = (outs["fma"][1] - outs["nofma"][1]).abs()
    say(f"[fmad] medians in run order nofma, fma, fma, nofma: {meds} on {card}")
    say(f"[fmad] rate b, fma vs nofma build: max |Δb| {float(db.max()):.6g}, "
        f"voxels differing {float((db > 0).float().mean()):.6f}")

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
