#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on a CUDA card, and check them.

Usage, from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --quick    # phases 1-3 only: build, small cases
    python3 chip_smoke.py --qdess-only  # phases 1 and 11 only
    python3 chip_smoke.py --scans-only  # phases 1, 2, 12 and 13 only
    python3 chip_smoke.py --train-only  # phases 1, 2 and 14 only

Phases (any failure raises and exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build every kernel from dosma_tpu_torch/csrc/, one nvcc process per
     source, all started together: monoexp_lm.cu, biexp_lm.cu,
     warp_grid.cu and the generic LM kernel generated for each model used
     below; print the nvcc seconds and the ptxas register
     and spill counts (for warp_grid, each order's kernel); beside them,
     g++ builds the host DICOM reader and codecs (csrc/host/*.cpp);
  3. hold each kernel against its plain PyTorch version on the card at
     small shapes: edge cases (all-zero voxel, y_bounds, nan_policy="keep"
     with one iteration, N not a multiple of the block, per-voxel p0, a
     seed whose cost is inf), several T (biexp: uniform echoes from T = 3,
     which take the e0 * q^t columns, and uneven ones at T = 8, which take
     exact exponentials), and for the generic kernel models
     with P = 1, 2, 3, 4 built from every whitelisted operation.
     Tolerance: |Δ| <= 1e-5 * max(1, |v|) on every parameter and r2 of
     every voxel, identical NaN and infinity positions, converged flags
     equal on >= 99.9% of voxels. The warp kernel, orders 1 and 3: identity,
     a rotation with a shift, a map partly outside the volume, an axis
     permutation, NB = 1, 3, 9, one matrix per group, output shapes that
     differ from the source, cut tiles at the output's edges (no dim a
     multiple of the tile, one point along an axis), a zoom-out by 3 (which
     must take the gather branch) and a NaN matrix; each case prints the
     branch its blocks take (ops/warp.py::warp_branches); every voxel within
     1e-5 * max(1, |v|), identical NaN positions, bit equality required;
  4. monoexponential relaxometry (the first slice's main path): four
     512x512x64 echo volumes on the card (16.7M voxels, noisy data made
     from seed 0) through MonoExponentialFit(bounds=(0, 100),
     tc0="polyfit").fit and the T2 map's regional metrics; the kernel's
     launch count over that run; scipy parity of the map on 2,000 voxels
     (relative RMSE of tc < 5e-3); kernel and plain version compared on
     every voxel with the tolerance above, and timed (CUDA events, median
     of 5 after a warm-up); the registers and spill bytes of the kernel's
     instantiation on this path, from its ptxas report;
  5. biexponential fit at full width: 512x512x16 voxels x 8 echoes (the
     data of bench.py's biexp config, seed 0) as volumes on the card
     through CurveFitter(biexponential).fit; exactly one biexp_lm launch;
     the maps stay on the card; kernel and plain version compared on every
     voxel; scipy parity on 2,000 voxels (relative RMSE of each parameter
     < PARITY_GATE_FIT); converged fraction; kernel, plain version and warm
     fit timed; the kernel's registers and spill bytes, as in phase 4;
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
     one volume, between two events and, from torch.profiler, the kernel
     alone;
  9. a DICOM series in, T2 maps and metrics out, at config1's full width:
     phase 4's echoes (seed 0) scaled to uint16 and written by the port's
     DicomWriter as 256 single-frame files (EchoNumbers, EchoTime); the
     host libraries must be the port's own builds; read back by
     DicomReader(num_workers=8) (host) and load_to_device (pinned, side
     stream) onto the card: 4 volumes of 512x512x64 with the written
     affine, echo times and pixels; MonoExponentialFit(tc0="polyfit") on
     the card volumes: exactly one monoexp_lm launch, the map bit-equal to
     the same fit of the rounded echoes given as arrays; qdess_t2_map of
     echoes 1 and 2 on the card against a numpy float64 evaluation (every
     voxel within 1e-4 * max(1, |v|), NaN placement identical except at
     voxels within that tolerance of a bound; with decimals=1, each voxel
     that differs does so by 0.1 at a rounding boundary or at a bound);
     T2.metric_rows with the two-label mask as a uint16 volume against
     numpy float64 over the host map (categories and voxel counts equal,
     Mean / Std / Median within rtol 1e-6); the map's NIfTI save_data /
     load_data and one echo's DicomWriter round trip, equal; the warm wall
     from the directory to metric rows (median of 3) with its breakdown:
     read and parse, H2D pinned against pageable, fit (with one header
     copy's time and a cProfile of one fit by own time), metrics, write.
 10. knee segmentation at full width: bench.py's config4 model,
     IWOAIOAIUnet2DNormalized (4 classes, whitened with eps 0), with the
     full-width U-Net (34,597,892 parameters, He-normal from
     RandomState(0)) set through Unet2D.params, on an OAI DESS knee of
     384x384x160 sagittal voxels of 0.3x0.3x0.7 mm (RandomState(4) x 1000,
     float32), batches of preferences.segmentation_batch_size (64), with
     cudnn.allow_tf32 True for the whole phase (PyTorch's default). Checks:
     (1) the card's float32 probabilities on 2 slices within SEG_F32_TOL of
     the port's float64 forward on the CPU, a mask differing only within it
     of 0.5 (fails if TF32 reaches the convolutions); (2) generate_mask of
     the host volume equals the threshold of the card's probabilities on
     those slices for fc, tc, pc and men; (3) the volume already on the
     card gives the same masks; (4) one generate_mask moves the packed mask
     (384*384*160*4 bits) and at most 1 KB more from the card
     (torch.profiler's memcpy events); (5) bfloat16's max |Δp| against
     float32 and the share of mask voxels that differ stay within
     SEG_BF16_MAX_ABS_ERR and SEG_BF16_MASK_SHARE. Prints the warm
     generate_mask walls (median of 3, host and card volume), slices/s, the
     forward alone (CUDA events a batch), the float32 bound (the
     convolutions' operations over 67 TFLOP/s) and the bfloat16 one, the
     idle share of one call, bfloat16's times and the peak memory, and a
     "segmentation" JSON line before the kernels line.
 11. the qDESS knee, from a DICOM series to per-region T2 rows: two uint16
     echoes of 384x384x160 (echo 1 phase 10's recipe, RandomState(4) x
     1000; echo 2 echo 1 x U(0.2, 0.6) from RandomState(5)) written by
     DicomWriter as a sagittal series of 320 files with TR, TE, the flip
     angle and GE's private spoiler tags (0019,10B6) / (0019,10B7);
     QDess.from_dicom on the host and with to_device=True (equal pixels,
     the tags read back); segment(phase 10's model, the four knee tissues,
     use_rss=True): each tissue's mask is its channel of
     model.generate_mask(scan.calc_rss()) (largest_cc for fc and pc); the
     condyle arc of bench.py:544-553 (1.54M voxels) set on every tissue;
     generate_t2_map(tissue=...) on the card echoes, bit-equal to
     ops.qmri.qdess_t2_map with the header's parameters; each tissue's
     quant_rows on the card map against the same on its host copy
     (categories and counts equal, statistics and unrolled maps within
     rtol 1e-9, equal NaN positions); each analytics call copies at most 8
     bytes a masked voxel + 1 MB to the host (profiler memcpy events).
     Prints the warm walls (median of 3) of the directory -> rows path with
     the card's busy and idle share, from_dicom, segment, generate_t2_map,
     largest_cc, each set_mask and each tissue's analytics, the D2H bytes,
     the peak memory, and a "qdess_knee" JSON line before the kernels line.
     No hand kernel runs on this path.
 12. the registered scans: CubeQuant at 384x384x160 from a DICOM series
     to femoral cartilage's T1ρ rows: bench.py's config 3 recipe
     (RandomState(3), spin locks 1/10/30/60 ms, T1ρ U(20, 100), a box of
     1000 + 50 U(0, 1), spin lock i rolled by (i, -i, 0)) as 640 uint16
     files; the target is spin lock 1 rolled by (3, -2, 1) and the condyle
     arc rolled the same way its mask, both NIfTI.
     CubeQuant.from_dicom(to_device=True) -> intraregister() ->
     interregister(target, arc) -> generate_t1_rho_map(tissue=fc) ->
     fc.quant_rows. Checks: one warp_grid launch in each registration and
     one monoexp_lm launch in the fit; recovery of the known rolls < 0.5
     voxel (largest corner displacement, from the transform files); the
     fit's and both warps' kernel outputs against their plain versions on
     the same inputs (recorded from the path's own calls); scipy parity of
     the map on 2,000 voxels inside the box and the arc (< 5e-3); fc's rows
     on the card map against its host copy (rtol 1e-9); the
     interregistered transform files warp the intraregistered volumes onto
     the result again. Prints the first call's wall (no warm rerun) with
     the card's busy share over it (nvidia-smi), peak memory and a breakdown
     (read, each registration's ms an Adam iteration, the order-3
     prefilters, the final warps' kernel against its bound, the fit, the
     rows). Then MAPSS (7 echoes, echoes 1-6 rolled by (1, -1, 0):
     intraregister, T1ρ and T2) and Cones (4 echoes: interregister to the
     last echo rolled by (2, -1, 1), T2*) at 192x192x48 on the card, one
     run each with the same launch, recovery and kernel checks;
 13. B-spline registration: register(..., "bspline") on bench.py's recipe
     (_bench_bspline_registration: 192x192x48 at 0.5x0.6x2.0 mm, blobs and
     a +-2-voxel sinusoidal field, RandomState(7)), held to its gates
     (residual RMSE < 0.1x, mean displacement error against the exact
     inverse < 0.3 voxel); one warm run's wall, ms an iteration, busy
     share; no warp_grid launch (the mixed chain samples points). Then
     apply_warp of 4 x 384x384x160 volumes under a rigid + B-spline
     transform-file chain, timed with CUDA events, volume 0's first 48
     rows against the port's CPU run of the same chain on that slab
     (1e-4 * max(1, |v|)).
 14. several cards and training, in a one-rank NCCL world: first
     ``python -m dosma_tpu_torch.parallel.dryrun --ranks <cards> --backend
     nccl`` (its own processes; its OK line); then SegTrainer at full width
     (num_classes 1, lr 1e-4) on 8 whitened 384x384 slices of phase 10's
     knee with the condyle arc's labels, 5 steps on one batch: finite,
     falling losses, each step's CUDA-event time beside the bound (3 x the
     forward's float32 operations over 67 TFLOP/s), peak memory; a
     checkpoint saved at step 3 and restored into a fresh trainer, whose
     step 4 equals the live trainer's bit for bit (loss and parameters);
     one slice's gradients on the card against float64 on the CPU, each
     leaf within the larger of 1e-4 and float32's own error there (float32
     on the CPU); sharded_lm_fit of the library monoexponential,
     biexponential and a user model on phases 4-6's data: one launch of
     the model's kernel each, rows bit-equal to the unsharded kernel's;
     profiling.trace around a warm sharded fit (in a fresh process) holds
     the monoexp_lm kernel;
     sharded_register_chain_batch of two rolled phantoms (phase 7's): one
     warp_grid launch, equal to register_chain_batch's; sharded U-Net
     inference on 160 knee slices at full width within 1e-5 of UNet2D's
     forward; the sharded qDESS flow on phase 11's echoes:
     load_to_device(sharding=...), a sharded T2 map bit-equal to the
     unsharded card map, femoral cartilage's rows equal to the unsharded
     map's (rtol 1e-9).
Phases 4-6 also recount the LM work: each kernel is run at max_iter = 1 ..
max_iter on its path's data, which gives every voxel's latch iteration (its
mean, p50, p99 and max, and the warp-divergence factor) and the bound's
operation side (mean iterations x operations an iteration); phases 4 and 6
also print the factor modelled for lane refill.
Phases 7-8 print the point-per-thread warp kernel's times (PERF.md) and
the branch counts of ops/warp.py::warp_branches beside this run's, on the
readable lines only.
Each path (phases 4, 5, 6, 7, 9, 10, 11, 12, 13, and each of phase 14's
sharded paths) runs with every launch count set to 0 just before it and
read just after (phases 10, 11 and 13 launch none). `--qdess-only` runs phase 11 alone after phase 1;
`--scans-only` phases 12 and 13 after the build; `--train-only` phase 14
after the build. The last seven lines are
the segmentation object, the qDESS knee object, the registered-scans,
B-spline and parallel/training objects, one JSON object with every
kernel (its bound: the larger of the bytes it must move over 3.35 TB/s and
its float32 operations over 67 TFLOP/s) and the result object. It imports
nothing of JAX.
"""

import argparse
import concurrent.futures
import copy
import functools
import json
import os
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
KNEE_CPU_ROWS = 48  # phase 13: rows of the knee's output that the CPU run recomputes
WARP_AFFINE = np.diag([0.5, 0.5, 2.0, 1.0])  # bench.py:697-706
WARP_ANGLE, WARP_SHIFT = 0.07, (1.2, -0.7, 0.4)

# H100 SXM peaks (NVIDIA data sheet): the bound of a kernel is the larger of
# its bytes over the memory rate and its float32 operations over the
# float32 (non-tensor-core) rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12  # dense, on the tensor cores

# Phase 10: bench.py's config4 model (IWOAIOAIUnet2DNormalized, 4 classes)
# on an OAI DESS knee (bench.py:457-461), 160 sagittal slices of 384x384.
SEG_SPACING = (0.3, 0.3, 0.7)
SEG_CHECK_SLICES = (5, 150)  # in the first and the last batch of 64
SEG_F32_TOL = 1e-4  # |Δp| of the card's float32 against float64 on the CPU
# bfloat16 against float32: max |Δp| on the check slices' batches, and the
# share of mask voxels that differ. Bounds: about twice this phase's first
# full run (0.01283 and 0.001194 on an NVIDIA H100 80GB HBM3 at 700 W).
SEG_BF16_MAX_ABS_ERR = 0.03
SEG_BF16_MASK_SHARE = 0.003

# The point-per-thread warp kernel that the staged one replaced, on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md's kernel table):
# printed beside this run's times; never a pass or fail criterion.
POINT_KERNEL_KNEE_MS = {1: 0.7873, 3: 2.3306}
POINT_KERNEL_PREFILTER_MS = 43.8122
POINT_KERNEL_BENCH_MS = 0.0859
POINT_KERNEL_REGISTER_WARM_S = 4.1148
POINT_KERNEL_APPLY_WARP_S = 0.0613


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


def device_ms(fn, reps, name):
    """Median duration on the card of the kernels whose name holds ``name``
    over ``reps`` calls of ``fn`` (one such kernel a call), from
    torch.profiler's trace: the kernel alone, which the wrapper's host work
    between two events cannot reach. Each session traces ``reps`` calls and
    throws them away (the schedule's warm-up step), then traces the
    measured ``reps``: sessions without that step now and then lost kernel
    events (``tools/profiler_event_probe.py``). A session that saw another
    count than ``reps`` is measured again, up to three. Returns the ms and
    the count each session saw."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    counts = []
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _step in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        counts.append(len(us))
        if len(us) == reps:
            break
    check(len(us) == reps, f"the profiler saw {counts} {name} kernels in {reps} calls")
    return float(np.median(us)) / 1e3, counts


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


def lm_bound(yT, out_rows, flops_per_iteration, mean_iterations):
    """Bound of an LM kernel: y read once, the packed rows written once; the
    operations of the LM iterations these data need (their measured mean a
    voxel, see latch_iterations)."""
    T, N = yT.shape
    nbytes = T * N * 4 + out_rows * N * 4
    return bound(nbytes, flops_per_iteration * mean_iterations * N)


def latch_iterations(packed, max_iter):
    """Each voxel's latch iteration, from the kernel run at max_iter = 1 ..
    max_iter: every voxel freezes at its latch, so "converged with max_iter =
    k" is "latched by iteration k", and a voxel that latches at iteration L
    is converged in max_iter + 1 - L of the runs. A voxel converged in none
    (it never latched, or its seed or result is not finite) counts max_iter.
    ``packed(k)`` returns the packed rows, the converged flags last."""
    runs = None
    for k in range(1, max_iter + 1):
        conv = packed(k)[-1]
        runs = conv.clone() if runs is None else runs + conv
    return torch.clamp(max_iter + 1 - runs, max=max_iter).to(torch.int64)


def refill_factor(L, lanes):
    """Lane passes over useful passes of a kernel whose lanes each take the
    next voxel as soon as theirs latches (generic_lm.cuh), modelled on
    ``lanes`` lanes in lockstep: a voxel holds its lane max(L, 1) passes and
    a warp runs until its last lane is done."""
    cost = np.maximum(L.cpu().numpy(), 1)
    n = cost.size
    busy = cost[:lanes].copy()
    ptr = busy.size
    while ptr < n:
        idle = np.flatnonzero(busy == busy.min())[: n - ptr]
        busy[idle] += cost[ptr:ptr + idle.size]
        ptr += idle.size
    pad = (-busy.size) % 32
    warp_passes = np.concatenate([busy, np.zeros(pad, busy.dtype)]).reshape(-1, 32).max(1)
    return float(warp_passes.sum() * 32 / cost.sum())


def iteration_report(name, L, max_iter, refill=False):
    """Mean, p50, p99 and max of the latch iterations, and the warp-divergence
    factor: the mean over warps of the largest latch iteration among 32
    consecutive voxels, over the mean latch iteration (a warp of a
    one-voxel-a-thread kernel runs as long as its slowest voxel). With
    ``refill``, also prints the factor modelled for lane refill on every
    SM's most resident threads (2048), which overstates the tail; a host
    model, so it stays out of the returned numbers."""
    N = L.numel()
    counts = torch.bincount(L, minlength=max_iter + 1).cpu().numpy()
    cdf = np.cumsum(counts) / N
    mean = float(L.double().mean())
    pad = (-N) % 32
    warp_max = torch.cat([L, L.new_zeros(pad)]).reshape(-1, 32).amax(1).double()
    rep = {"mean": mean, "p50": int(np.searchsorted(cdf, 0.5)),
           "p99": int(np.searchsorted(cdf, 0.99)), "max": int(L.max()),
           "at_max_iter": int(counts[max_iter]),
           "warp_divergence_factor": float(warp_max.mean()) / mean}
    modelled = ""
    if refill:
        lanes = torch.cuda.get_device_properties(0).multi_processor_count * 2048
        modelled = f"; with lane refill (modelled) {refill_factor(L, lanes):.4f}"
    print(f"latch iterations {name} (max_iter 1..{max_iter}, {max_iter} launches): mean "
          f"{rep['mean']:.4f} p50 {rep['p50']} p99 {rep['p99']} max {rep['max']}; voxels at "
          f"max_iter {rep['at_max_iter']}; warp-divergence factor "
          f"{rep['warp_divergence_factor']:.4f}{modelled}")
    return rep


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
    host = {f"{name}.cpp (g++)": lambda n=name: _build.load_host_library(n)
            for name in ("dosma_io", "dosma_codecs")}
    for name, (model, nparams, _, _) in GENERIC_MODELS.items():
        program = compile_model(model, nparams)
        jobs[f"generic_lm ({name})"] = lambda p=program: build_kernel(p)
    for name, program in sharded_programs().items():
        jobs[f"generic_lm ({name})"] = lambda p=program: build_kernel(p)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs) + len(host)) as pool:
        libs = {k: pool.submit(fn) for k, fn in {**jobs, **host}.items()}
        libs = {k: f.result() for k, f in libs.items()}
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s wall, in parallel")
    for name in host:
        print(f"  {name}: {libs.pop(name).build_seconds:.2f} s")
    for name, lib in libs.items():
        log = lib.build_log.read_text()
        kernels = ptxas_kernels(log).values()
        regs, spills = [r for r, _ in kernels], [b for _, b in kernels]
        print(f"  {name}: nvcc {lib.build_seconds:.2f} s; ptxas: {len(regs)} kernels, "
              f"registers {min(regs, default=0)}-{max(regs, default=0)}, "
              f"spill bytes {sum(spills)}")
        if name == "warp_grid.cu":  # one kernel per order
            for order, used in re.findall(r"warp_tilesILi(\d)E.*?Used (\d+) registers", log,
                                          flags=re.S):
                print(f"    warp_tiles<{order}>: {used} registers")
        for line in log.splitlines():
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                print("    ptxas:", line.strip())


def ptxas_kernels(log):
    """{mangled kernel name: (registers, spill bytes)} from a ptxas -v log."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        out[name] = (int(regs.group(1)) if regs else -1,
                     int(spill.group(1)) + int(spill.group(2)) if spill else 0)
    return out


def lm_registers(lib_name, kernel, T, uniform):
    """Registers and spill bytes of the instantiation of an LM kernel that a
    path launches (T echoes, uniform or exact columns), from its build log;
    printed, and returned as (registers, spill bytes)."""
    from dosma_tpu_torch.ops import _build

    found = [v for k, v in ptxas_kernels(_build.load_library(lib_name).build_log.read_text()).items()
             if re.search(rf"{kernel}ILi{T}ELb{int(uniform)}E", k)]
    check(len(found) == 1, f"ptxas log of {lib_name}: {len(found)} entries for {kernel}<{T}, "
          f"{uniform}>")
    regs, spill = found[0]
    print(f"ptxas {kernel}<T={T}, uniform={uniform}>: {regs} registers, {spill} spill bytes")
    return regs, spill


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
    def data(N, T=8, noise=0.0, x=None):
        x = np.linspace(0.0, 10.0, T).astype(np.float32) if x is None else x
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
    for T in (2, 3, 5, 8, 11):
        cases.append((f"T{T}", *data(777, T=T, noise=0.01), p0, kw))
    uneven = np.cumsum(np.linspace(0.5, 2.5, 8)).astype(np.float32)  # exact columns at T = 8
    cases.append(("T8_nonuniform", *data(777, noise=0.01, x=uneven), p0, kw))
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
        # Tiles cut by the output's edges: no output dim a multiple of the
        # tile (16x16x32 or 8x16x32), and outputs of one point along an axis.
        ("tile_edges", 2, (21, 19, 37), (17, 35, 33), rotation_B((21, 19, 37), 2, (0.3, -0.4, 0.2))),
        ("one_point_along_i", 1, (12, 20, 40), (1, 20, 40), rotation_B((12, 20, 40), 3, (2.0, 0.5, -0.3))),
        ("one_point_along_k", 3, (20, 20, 5), (20, 20, 1), rotation_B((20, 20, 5), -4, (0.1, 0.6, 1.7))),
        # A zoom-out by 3: the boxes of the tiles inside the volume overflow
        # the staging buffer, so those blocks gather.
        ("zoom_out_3", 2, (40, 44, 72), (40, 44, 72), rotation_B((40, 44, 72), 3, (0.4, -0.2, 0.3), 3.0)),
        ("nan_matrix", 1, (10, 10, 10), (9, 9, 9), np.full((3, 4), np.nan, np.float32)),
        # A small output well inside a larger source: the order-1 boxes lie
        # inside the volume, so those blocks take the unmasked taps.
        ("inside_the_source", 3, (40, 44, 72), (20, 22, 36),
         rotation_B((40, 44, 72), 2, (10.0, 11.0, 18.0))),
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
    """Phase 3, warp kernel: each case and order against the plain version,
    with the branch its blocks take (staged box or gather, named by
    warp_branches); every case must agree bit for bit; the zoom-out must
    gather."""
    from dosma_tpu_torch.ops.warp import (
        prepare_sources, warp_branches, warp_grid, warp_grid_reference,
    )

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
            check(equal, f"warp_grid differs from its plain version: {name} order {order}")
            br = warp_branches(B, srcs.shape[1:], out_shape, order)
            if name == "zoom_out_3":
                check(br["gather"] > 0, f"zoom_out_3 order {order} took no gather branch: {br}")
            worst = max(worst, err)
            n_equal += equal
            n_cases += 1
            print(f"compare warp_grid {name} order {order}: NB={nb} {src_shape} -> {out_shape} "
                  f"blocks staged {br['staged']} gather {br['gather']} "
                  f"(read amplification {br['read_amplification']:.3g}); max|Δ|={err:.3g} "
                  f"bit-equal={equal}")
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
@functools.lru_cache(maxsize=None)
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
    iters = iteration_report("monoexp_lm", latch_iterations(
        lambda k: _packed_kernel(x_dev, yT, None, k, 1e-5, 1e-5, True), 100), 100, refill=True)
    b_ms, b_by = lm_bound(yT, 4, 20 * T + 40, iters["mean"])
    regs, spill = lm_registers("monoexp_lm", "monoexp_lm_kernel", T, True)
    return {"launches": launches, "max_abs_err": max(max_err, max_err_r2),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "iterations": iters, "registers": regs, "spill_bytes": spill}


# ----------------------------------------------------------------------
# Phases 5 and 6: the curve-fitting path at full width
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
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


@functools.lru_cache(maxsize=None)
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
    from dosma_tpu_torch.ops.biexp import (
        _packed_kernel, _reference_rows, _uniform_path, biexp_lm, biexp_lm_reference,
    )

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
    uniform = _uniform_path(BIEXP_X)
    args = (x_dev, yT, p0_dev, 100, 1e-5, 1e-5, uniform)
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
    iters = iteration_report("biexp_lm", latch_iterations(
        lambda k: _packed_kernel(x_dev, yT, p0_dev, k, 1e-5, 1e-5, uniform), 100), 100)
    b_ms, b_by = lm_bound(yT, 6, 40 * T + 80, iters["mean"])
    regs, spill = lm_registers("biexp_lm", "biexp_lm_kernel", T, uniform)
    return {"launches": counts["biexp_lm"], "iterations": iters,
            "registers": regs, "spill_bytes": spill,
            "max_abs_err": max(err, err_r2), "ms": kernel_ms,
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
    iters = iteration_report("generic_lm", latch_iterations(
        lambda k: _packed_kernel(program, x_dev, yT, p0_dev, k, 1e-5, 1e-5), 60), 60, refill=True)
    b_ms, b_by = lm_bound(yT, 5, 30 * T + 50, iters["mean"])
    return {"launches": counts["generic_lm"], "iterations": iters,
            "max_abs_err": max(err, err_r2), "ms": kernel_ms,
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


def corner_error_vox(M_est, affine=REG_AFFINE, shape=REG_SHAPE, shift=REG_SHIFT):
    """Largest displacement error over the volume corners, in voxels of the
    index grid: the estimated fixed → moving index map against the known
    shift (moving index = fixed index + shift)."""
    A = np.asarray(affine, np.float64)
    B_est = np.linalg.inv(A) @ np.asarray(M_est) @ A
    corners = np.array([[i, j, k, 1.0] for i in (0, shape[0] - 1)
                        for j in (0, shape[1] - 1) for k in (0, shape[2] - 1)]).T
    want = corners[:3] + np.asarray(shift, np.float64)[:, None]
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
        print(f"phase 7: apply_warp of 4 volumes: {apply_s:.4f} s "
              f"(point kernel: {POINT_KERNEL_APPLY_WARP_S} s), "
              f"launches {apply_counts}; warm register median {statistics.median(walls):.4f} s "
              f"(point kernel: {POINT_KERNEL_REGISTER_WARM_S} s)")
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
    8 sums). Order 3, summed separably: 45 for the 3x4 B-spline weights in
    closed form (15 an axis), then a volume 147: 16 rows of 4 taps along k
    (4 products, 3 sums each: 112), 4 along j (28), 1 along i (7). At 4
    volumes that is 651 a point (the 64-weight form counted 143 + 128 a
    volume, 655)."""
    npts = int(np.prod(out_shape))
    nbytes = 4 * (int(np.prod(srcs_shape)) + nb * npts)
    per_point = (39 + 16 * nb) if order == 1 else (63 + 147 * nb)
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
    from dosma_tpu_torch.ops.warp import (
        prepare_sources, warp_branches, warp_grid, warp_grid_reference,
    )

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
        check(equal, f"warp_grid differs from its plain version at the knee size, order {order}")
        br = warp_branches(B.cpu().numpy(), srcs.shape[1:], out_shape, order)  # a host model
        kernel_ms, kernel_all = time_ms(lambda: warp_grid(srcs, B, out_shape, order))
        plain_ms, plain_all = time_ms(lambda: warp_grid_reference(srcs, B, out_shape, order))
        nbytes, flops = warp_work(tuple(srcs.shape), out_shape, KNEE_VOLUMES, order)
        b_ms, b_by = bound(nbytes, flops)
        entry = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "bytes": nbytes, "flops": flops, "max_abs_err": err, "bit_equal": equal}
        line = (f"  order {order}: kernel {kernel_ms:.4f} ms runs {[round(t, 4) for t in kernel_all]}"
                f" (the point kernel: {POINT_KERNEL_KNEE_MS[order]} ms); plain "
                f"{plain_ms:.4f} ms; "
                f"{nbytes / 1e6:.1f} MB, {nbytes / kernel_ms / 1e9:.4g} TB/s achieved; bound "
                f"{b_ms:.4f} ms by {b_by} ({b_ms / kernel_ms:.3g} of it); warp_branches: blocks "
                f"staged {br['staged']} gather {br['gather']}, read amplification "
                f"{br['read_amplification']:.4g}, {br['volumes_per_buffer']} volumes a buffer; "
                f"max|Δ| {err:.3g}, bit-equal {equal}")
        if order == 3:
            pre_ms, pre_all = time_ms(lambda: prepare_sources(vols, 3))
            entry["prefilter_ms"] = pre_ms
            line += (f"; prefilter alone {pre_ms:.4f} ms "
                     f"(point kernel: {POINT_KERNEL_PREFILTER_MS} ms)")
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
    bench_kernel_ms, seen = device_ms(lambda: warp_grid(vol, B, REG_SHAPE, 1), 21, "warp")
    n = int(np.prod(REG_SHAPE))
    print(f"  bench size {REG_SHAPE}, one volume, order 1: {bench_ms:.4f} ms between two "
          f"events, the wrapper's host work included (point kernel: {POINT_KERNEL_BENCH_MS} "
          f"ms) runs {[round(t, 4) for t in bench_all]}; the kernel alone {bench_kernel_ms:.4f} "
          f"ms ({n / bench_kernel_ms / 1e3:.4g} Mpts/s; profiler, median of 21; kernel events "
          f"seen in each session {seen})")
    res["bench_ms"] = bench_ms
    res["bench_kernel_ms"] = bench_kernel_ms
    res["max_abs_err"] = worst
    return res


# ----------------------------------------------------------------------
# Phase 9: a DICOM series in, T2 maps and metrics out
# ----------------------------------------------------------------------
DICOM_SCALE = 40000.0  # config1's echoes (about 0..1) to uint16
DICOM_SPACING = (0.3125, 0.3125, 1.5)
# tests/scan_sequences/mri/test_qdess.py's acquisition: TR, TE, t1 in ms,
# tg in microseconds, alpha in degrees, the spoiler area.
QDESS_PHYSICS = dict(tr=25.0, te=8.0, tg=1560.0, alpha=30.0, gl_area=3132.0, t1=1200.0)
QDESS_BOUNDS = (0.0, 100.0)


def dicom_headers():
    """(1, 1, slices, echoes) headers of config1 as an axial series: one
    dataset per slice and echo, EchoNumbers and EchoTime set."""
    from dosma_tpu_torch.core.io.dicom import Dataset
    from dosma_tpu_torch.core.io.dicom.writer import generate_uid

    series = generate_uid()
    nslices, T = SHAPE[2], ECHO_TIMES.size
    headers = np.empty((1, 1, nslices, T), dtype=object)
    for e in range(T):
        for s in range(nslices):
            ds = Dataset()
            ds.SOPInstanceUID = generate_uid()
            ds.SeriesInstanceUID = series
            ds.Modality = "MR"
            ds.InstanceNumber = e * nslices + s + 1
            ds.EchoNumbers = e + 1
            ds.EchoTime = float(ECHO_TIMES[e])
            ds.RepetitionTime = QDESS_PHYSICS["tr"]
            ds.FlipAngle = QDESS_PHYSICS["alpha"]
            ds.Rows, ds.Columns = SHAPE[0], SHAPE[1]
            ds.BitsAllocated, ds.BitsStored, ds.HighBit = 16, 16, 15
            ds.PixelRepresentation = 0
            ds.SamplesPerPixel = 1
            ds.PhotometricInterpretation = "MONOCHROME2"
            ds.PixelSpacing = [DICOM_SPACING[0], DICOM_SPACING[1]]
            ds.SliceThickness = DICOM_SPACING[2]
            ds.ImagePositionPatient = [0.0, 0.0, DICOM_SPACING[2] * s]
            ds.ImageOrientationPatient = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
            headers[0, 0, s, e] = ds
    return headers


def qdess_t2_numpy(e1, e2, tr, te, tg, alpha, gl_area, t1, diffusivity=1.25e-9):
    """The qDESS analytic T2 in numpy float64, before its bounds: the plain
    evaluation phase 9 holds the port's float32 map against."""
    import math

    TR, TE, Tg, T1 = tr * 1e-3, te * 1e-3, tg * 1e-6, t1 * 1e-3
    a = math.radians(alpha)
    dkL = 4258 * 2 * math.pi * (gl_area / (Tg * 1e6) * 100) * Tg
    decay = math.exp(-TR / T1 - TR * dkL ** 2 * diffusivity)
    k = math.sin(a / 2) ** 2 * (1 + decay) / (1 - math.cos(a) * decay)
    c1 = (TR - Tg / 3) * dkL ** 2 * diffusivity
    e1, e2 = e1.astype(np.float64), e2.astype(np.float64)
    with np.errstate(all="ignore"):
        ratio = np.nan_to_num(e2 / e1)
        return np.nan_to_num(-2000.0 * (TR - TE) / (np.log(np.abs(ratio) / k) + c1))


def check_qdess(got_none, got_1, ref):
    """Phase 9's qDESS checks against the float64 map ``ref`` (before its
    bounds). Unrounded (NaN outside the bounds): every voxel finite in
    both within 1e-4 * max(1, |v|), NaN placement identical except at
    voxels within that tolerance of a bound. Rounded to 0.1 (NaN -> 0): a
    voxel that differs does so by 0.1 with its value at a rounding
    boundary, or sits at a bound. Returns the counts."""
    lo, hi = QDESS_BOUNDS
    tol = 1e-4 * np.maximum(1.0, np.abs(ref))
    at_bound = (np.abs(ref - lo) <= tol) | (np.abs(ref - hi) <= tol)
    ref_nan = (ref < lo) | (ref > hi)
    got_nan = np.isnan(got_none)
    placement = got_nan != ref_nan
    check(not (placement & ~at_bound).any(),
          f"qdess NaN placement differs at {int((placement & ~at_bound).sum())} voxels off the bounds")
    both = ~got_nan & ~ref_nan
    over = (np.abs(got_none[both] - ref[both]) > tol[both]).sum()
    check(over == 0, f"qdess: {int(over)} voxels beyond 1e-4 * max(1, |v|)")
    ref_1 = np.where(ref_nan, 0.0, np.round(ref, 1))
    diff = np.abs(got_1 - ref_1)
    differ = diff > 1e-4
    scaled = ref * 10
    at_half = np.abs(scaled - np.floor(scaled) - 0.5) <= 1e-3
    by_tenth = differ & (np.abs(diff - 0.1) <= 1e-4) & at_half
    check(not (differ & ~by_tenth & ~at_bound).any(),
          f"qdess decimals=1: {int((differ & ~by_tenth & ~at_bound).sum())} voxels differ by "
          "other than 0.1 at a rounding boundary or at a bound")
    err = float(np.abs(got_none[both] - ref[both]).max())
    return {"max_abs_err": err, "nan_placement_at_bound": int(placement.sum()),
            "rounded_differ": int(differ.sum()), "rounded_differ_by_tenth": int(by_tenth.sum()),
            "rounded_differ_at_bound": int((differ & ~by_tenth).sum()),
            "voxels_in_bounds": int(both.sum())}


def numpy_metric_rows(host_map, labels_np, labels):
    """T2.metric_rows computed with numpy in float64 over the host map."""
    finite = np.isfinite(host_map)
    regions = [(name, labels_np == label) for label, name in labels.items()]
    regions.append(("total", labels_np > 0))
    rows = []
    for name, sel in regions:
        v = host_map[sel & finite].astype(np.float64)
        rows.append({"Category": name, "Mean": float(np.mean(v)), "Std": float(np.std(v)),
                     "Median": float(np.median(v)), "# Voxels": int(v.size)})
    return rows


def check_metric_rows(rows, want, rtol=1e-6):
    """Categories and voxel counts equal, Mean / Std / Median within
    ``rtol``; returns the largest relative difference."""
    check([(r["Category"], r["# Voxels"]) for r in rows]
          == [(r["Category"], r["# Voxels"]) for r in want],
          f"metric rows {rows} differ from numpy's {want} in categories or voxel counts")
    worst = 0.0
    for r, w in zip(rows, want):
        for col in ("Mean", "Std", "Median"):
            rel = abs(r[col] - w[col]) / abs(w[col])
            check(rel <= rtol, f"metric rows: {r['Category']} {col} {r[col]} vs numpy's "
                               f"{w[col]} (rel {rel:.3g} > {rtol:g})")
            worst = max(worst, rel)
    return worst


def fit_profile(fit, top=8):
    """cProfile of one warm call of ``fit``: its host wall and the ``top``
    functions by own time, as printable lines (ms)."""
    import cProfile
    import pstats

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fit()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    worst = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    lines = [f"own {tt * 1e3:8.3f} ms  with callees {ct * 1e3:8.3f} ms  calls {nc:6d}  "
             f"{path.replace(os.getcwd() + os.sep, '')}:{line}({name})"
             for (path, line, name), (_, nc, tt, ct, _) in worst]
    return wall, lines


def median_wall(fn, reps=3):
    """Median and all of ``reps`` host walls of ``fn`` (synchronized)."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def device_busy_share(fn):
    """(host wall s, device busy ms, idle share) of one call of ``fn``: the
    union of the card's kernel and copy intervals in torch.profiler's trace,
    against the host wall around the call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -np.inf
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return wall, busy_us / 1e3, 1.0 - busy_us / 1e6 / wall


def phase_dicom(dt, dev, card):
    from dosma_tpu_torch.core.io import _native
    from dosma_tpu_torch.core.io.dicom_io import to_RAS_affine
    from dosma_tpu_torch.ops.qmri import qdess_t2_map

    T = ECHO_TIMES.size
    t0 = time.perf_counter()
    _, echoes, labels_np = config1_data(seed=0)
    u16 = np.stack([np.clip(np.round(e * DICOM_SCALE), 0, 65535).astype(np.uint16)
                    for e in echoes], axis=-1)
    del echoes
    headers = dicom_headers()
    affine = to_RAS_affine(list(headers[0, 0, :, 0]))
    print(f"phase 9 data: config1 (seed 0) x {DICOM_SCALE:g} as uint16 {u16.shape}, "
          f"{u16.nbytes / 1e6:.1f} MB of pixels, in {time.perf_counter() - t0:.2f} s (host)")

    for lib in (_native._load(), _native._load_codecs()):
        path = os.path.realpath(lib._name)
        check(os.path.dirname(path).endswith(os.path.join("dosma_tpu_torch", "_build")),
              f"host library {path} is not the port's own build")
    print(f"phase 9 host libraries: {os.path.basename(_native._load()._name)}, "
          f"{os.path.basename(_native._load_codecs()._name)} (dosma_tpu_torch/_build, g++)")

    work = tempfile.mkdtemp(prefix="chip_smoke_dicom_")
    try:
        series_dir = os.path.join(work, "series")
        t0 = time.perf_counter()
        dt.DicomWriter(num_workers=8).save(dt.MedicalVolume(u16, affine, headers=headers),
                                           series_dir)
        write_series_s = time.perf_counter() - t0
        files = sorted(os.listdir(series_dir))
        check(len(files) == SHAPE[2] * T, f"{len(files)} files written, not {SHAPE[2] * T}")
        nbytes = sum(os.path.getsize(os.path.join(series_dir, f)) for f in files)
        print(f"phase 9 write: DicomWriter(num_workers=8) {len(files)} files, "
              f"{nbytes / 1e6:.1f} MB, in {write_series_s:.3f} s")

        host = dt.DicomReader(num_workers=8).load(series_dir)
        card_vols = dt.load_to_device(series_dir, device=dev, num_workers=8)
        for name, vols in (("DicomReader", host), ("load_to_device", card_vols)):
            check(len(vols) == T, f"{name}: {len(vols)} groups, not {T}")
            for e, v in enumerate(vols):
                check(v.shape == SHAPE, f"{name}: echo {e + 1} shape {v.shape}")
                check(np.array_equal(v.affine, affine), f"{name}: echo {e + 1} affine")
                check(v.get_metadata("EchoTime") == float(ECHO_TIMES[e]),
                      f"{name}: echo {e + 1} EchoTime {v.get_metadata('EchoTime')}")
        for e, (h, c) in enumerate(zip(host, card_vols)):
            check(h.A.dtype == np.uint16 and np.array_equal(h.A, u16[..., e]),
                  f"DicomReader: echo {e + 1} pixels")
            want = torch.from_numpy(u16[..., e]).to(dev).to(torch.int32)
            check(c.A.device == want.device and c.A.dtype == torch.int32 and torch.equal(c.A, want),
                  f"load_to_device: echo {e + 1} pixels")
        print(f"phase 9 read: {T} groups of {SHAPE} by both readers, written affine, echo times "
              f"{[v.get_metadata('EchoTime') for v in host]}, pixels equal (uint16 on the host, "
              f"int32 on the card)")

        x = [v.get_metadata("EchoTime") for v in card_vols]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tc_map, r2_map = dt.MonoExponentialFit(tc0="polyfit").fit(x, card_vols)
        torch.cuda.synchronize()
        first_fit_s = time.perf_counter() - t0
        counts = expect_launches("DICOM fit", monoexp_lm=1)
        check(tc_map.A.device == dev and tc_map.shape == SHAPE, "the DICOM path's map")
        ref_map, _ = dt.MonoExponentialFit(tc0="polyfit").fit(
            ECHO_TIMES, [dt.MedicalVolume(u16[..., e], affine) for e in range(T)])
        host_map = tc_map.A.cpu().numpy()
        check(np.array_equal(host_map, ref_map.A, equal_nan=True)
              and np.array_equal(np.signbit(host_map), np.signbit(ref_map.A)),
              "the map fitted from DICOM differs from the fit of the same echoes as arrays")
        print(f"phase 9 fit: MonoExponentialFit(tc0='polyfit') on the card volumes, launches "
              f"{counts}, first call {first_fit_s:.4f} s; map bit-equal to the fit of the "
              f"rounded echoes given as arrays")

        physics = QDESS_PHYSICS
        got_none = qdess_t2_map(card_vols[0].A, card_vols[1].A, **physics, decimals=None,
                                nan_to_num=None).cpu().numpy().astype(np.float64)
        got_1 = qdess_t2_map(card_vols[0].A, card_vols[1].A, **physics).cpu().numpy()
        ref = qdess_t2_numpy(u16[..., 0], u16[..., 1], **physics)
        q = check_qdess(got_none, got_1.astype(np.float64), ref)
        qdess_ms, _ = time_ms(lambda: qdess_t2_map(card_vols[0].A, card_vols[1].A, **physics))
        print(f"phase 9 qdess_t2_map on the card vs numpy float64: max|Δ| {q['max_abs_err']:.3g} "
              f"over {q['voxels_in_bounds']} voxels in bounds; NaN placement differs at "
              f"{q['nan_placement_at_bound']} voxels, each at a bound; decimals=1: "
              f"{q['rounded_differ']} voxels differ ({q['rounded_differ_by_tenth']} by 0.1 at a "
              f"rounding boundary, {q['rounded_differ_at_bound']} at a bound); "
              f"{qdess_ms:.4f} ms on {card} (CUDA events, median of 5)")
        del got_none, got_1, ref

        labels = {1: "region_1", 2: "region_2"}
        mask = dt.MedicalVolume(labels_np.astype(np.uint16), affine)
        rows = dt.T2(tc_map).metric_rows(mask, labels)
        metrics_rel = check_metric_rows(rows, numpy_metric_rows(host_map, labels_np, labels))
        print(f"phase 9 metrics: categories and voxel counts equal to numpy's, Mean / Std / "
              f"Median within rel {metrics_rel:.3g} of numpy float64 (tolerance 1e-6)")
        for row in rows:
            print("  phase 9 metrics:", json.dumps(row))

        maps_dir = os.path.join(work, "maps")
        t0 = time.perf_counter()
        dt.T2(tc_map).save_data(maps_dir)
        save_map_s = time.perf_counter() - t0
        back = dt.T2()
        back.load_data(maps_dir)
        check(np.array_equal(back.volumetric_map.A, host_map, equal_nan=True)
              and np.array_equal(back.volumetric_map.affine, affine), "NIfTI map round trip")
        echo_dir = os.path.join(work, "echo3")
        t0 = time.perf_counter()
        dt.DicomWriter(num_workers=8).save(card_vols[2], echo_dir)
        save_echo_s = time.perf_counter() - t0
        echo_back = dt.DicomReader(num_workers=8).load(echo_dir)
        check(len(echo_back) == 1 and np.array_equal(echo_back[0].A, u16[..., 2])
              and np.array_equal(echo_back[0].affine, affine), "DICOM echo round trip")
        print(f"phase 9 round trips equal: T2 save_data/load_data (NIfTI, {save_map_s:.3f} s to "
              f"write), DicomWriter of echo 3 from the card ({save_echo_s:.3f} s) and back")

        # Warm walls (the files sit in the page cache), each the median of 3.
        def dir_to_metrics():
            vols = dt.load_to_device(series_dir, device=dev, num_workers=8)
            tc, _ = dt.MonoExponentialFit(tc0="polyfit").fit(
                [v.get_metadata("EchoTime") for v in vols], vols)
            return dt.T2(tc).metric_rows(mask, labels)

        wall_s, walls = median_wall(dir_to_metrics)
        prof_wall_s, busy_ms, idle = device_busy_share(dir_to_metrics)
        read_s, _ = median_wall(lambda: dt.DicomReader(num_workers=8).load(series_dir))
        prefetch_s, _ = median_wall(
            lambda: dt.load_to_device(series_dir, device=dev, num_workers=8))
        arrays = [np.ascontiguousarray(v.A) for v in host]
        pageable_s, _ = median_wall(lambda: [torch.from_numpy(a).to(dev) for a in arrays])
        pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
        pinned_s, _ = median_wall(lambda: [p.to(dev, non_blocking=True) for p in pinned])
        del pinned
        fit_s, _ = median_wall(lambda: dt.MonoExponentialFit(tc0="polyfit").fit(x, card_vols))
        prof_fit_s, prof_lines = fit_profile(
            lambda: dt.MonoExponentialFit(tc0="polyfit").fit(x, card_vols))
        copy_s, _ = median_wall(lambda: copy.deepcopy(card_vols[0].headers()))
        metrics_s, _ = median_wall(lambda: dt.T2(tc_map).metric_rows(mask, labels))
        moved = sum(a.nbytes for a in arrays)
        print(f"phase 9 on {card}: DICOM directory -> metric rows (load_to_device, fit, "
              f"metric_rows), warm, median of 3: {wall_s:.4f} s, runs "
              f"{[round(w, 4) for w in walls]}; one more run under torch.profiler: wall "
              f"{prof_wall_s:.4f} s, the card busy {busy_ms:.3f} ms (kernels and copies), "
              f"idle share {idle:.4f}")
        print(f"  read and parse (DicomReader(num_workers=8).load, host): {read_s:.4f} s")
        print(f"  load_to_device (read, parse, pinned H2D on a side stream): {prefetch_s:.4f} s; "
              f"read then a pageable copy would take {read_s + pageable_s:.4f} s")
        print(f"  H2D of the same {moved / 1e6:.1f} MB: pageable {pageable_s * 1e3:.3f} ms "
              f"({moved / pageable_s / 1e9:.3f} GB/s), pinned {pinned_s * 1e3:.3f} ms "
              f"({moved / pinned_s / 1e9:.3f} GB/s)")
        print(f"  fit (MonoExponentialFit.fit on the card volumes): {fit_s * 1e3:.3f} ms; "
              f"one deep copy of an echo's {card_vols[0].headers().size} headers (the fit "
              f"makes two) {copy_s * 1e3:.3f} ms; one more fit under cProfile "
              f"{prof_fit_s * 1e3:.3f} ms, by own time:")
        for line in prof_lines:
            print("    " + line)
        print(f"  metrics (T2.metric_rows, uint16 mask): {metrics_s * 1e3:.3f} ms")
        print(f"  write: T2.save_data (NIfTI .nii.gz) {save_map_s:.3f} s, DicomWriter of one "
              f"echo ({SHAPE[2]} files) {save_echo_s:.3f} s, the series ({len(files)} files) "
              f"{write_series_s:.3f} s")
        return {"wall_s": wall_s, "busy_ms": busy_ms, "idle_share": idle, "read_s": read_s, "prefetch_s": prefetch_s,
                "pageable_ms": pageable_s * 1e3, "pinned_ms": pinned_s * 1e3,
                "fit_ms": fit_s * 1e3, "header_copy_ms": copy_s * 1e3,
                "metrics_ms": metrics_s * 1e3, "metrics_rel_err": metrics_rel, "qdess_ms": qdess_ms,
                **q}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 10: knee segmentation at full width
# ----------------------------------------------------------------------
def he_normal_unet_params(rs, num_classes, features, in_channels=1):
    """U-Net parameters in the layout of ``init_unet2d_params`` (Keras
    kernels, zero biases, identity BatchNorm), kernels He-normal from the
    numpy RandomState ``rs``."""
    def conv(k, cin, cout, transpose=False):
        w = (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
        w = np.ascontiguousarray(w.transpose(0, 1, 3, 2)) if transpose else w
        return {"w": w, "b": np.zeros(cout, np.float32)}

    def bn(f):
        return {"gamma": np.ones(f, np.float32), "beta": np.zeros(f, np.float32),
                "mean": np.zeros(f, np.float32), "var": np.ones(f, np.float32)}

    params = {"down": [], "up": [None] * (len(features) - 1), "final": None}
    cin = in_channels
    for f in features:
        params["down"].append({"conv1": conv(3, cin, f), "conv2": conv(3, f, f), "bn": bn(f)})
        cin = f
    for d in range(len(features) - 2, -1, -1):
        f = features[d]
        params["up"][d] = {"convT": conv(3, features[d + 1], f, transpose=True),
                           "conv1": conv(3, 2 * f, f), "conv2": conv(3, f, f), "bn": bn(f)}
    params["final"] = conv(1, features[0], num_classes)
    return params


def unet_flops(h, w, features, num_classes, in_channels=1):
    """Multiply-adds x 2 of the U-Net's convolutions on one h x w slice
    (a transpose convolution: 9 products per input pixel, input and output
    channel); the elementwise work is not counted."""
    flops, sizes, cin = 0, [], in_channels
    for d, f in enumerate(features):
        flops += 2 * 9 * (cin + f) * f * h * w
        sizes.append((h, w))
        cin = f
        if d < len(features) - 1:
            stride = 2 if h % 2 == 0 else 3
            h, w = h // stride, w // stride
    for d in range(len(features) - 2, -1, -1):
        f = features[d]
        flops += 2 * 9 * features[d + 1] * f * h * w
        h, w = sizes[d]
        flops += 2 * 9 * (2 * f + f) * f * h * w
    return flops + 2 * features[0] * num_classes * h * w


def d2h_bytes(fn):
    """(bytes, copies) the card copied to the host while ``fn`` ran, from
    torch.profiler's memcpy events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]]
    check(all("bytes" in e.get("args", {}) for e in copies), "a memcpy event without bytes")
    return sum(int(e["args"]["bytes"]) for e in copies), len(copies)


def config4_model(params):
    """bench.py's config4 model at full width with ``params`` set (float32
    unless the precision preference says otherwise)."""
    from dosma_tpu_torch.models import IWOAIOAIUnet2DNormalized

    model = IWOAIOAIUnet2DNormalized((KNEE_SHAPE[0], KNEE_SHAPE[1], 1), None,
                                     force_weights=True)
    model.seg_model.params = params
    return model


def phase_segmentation(dt, dev, card):
    """Phase 10 (see the module docstring). TF32 stays allowed for the
    whole phase (PyTorch's default), so check 1 fails if it reaches the
    float32 convolutions."""
    from dosma_tpu_torch.models import IWOAIOAIUnet2DNormalized
    from dosma_tpu_torch.models.unet2d import FEATURES, UNet2D, cudnn_exact
    from dosma_tpu_torch.models.unet2d import _unpack as unpack

    prev_tf32 = torch.backends.cudnn.allow_tf32
    prev_precision = dt.preferences.segmentation_precision
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        arr = np.random.RandomState(4).rand(*KNEE_SHAPE).astype(np.float32) * 1000
        host = dt.MedicalVolume(arr, dt.to_affine(dt.SAGITTAL, SEG_SPACING))
        params = he_normal_unet_params(np.random.RandomState(0), 4, FEATURES)
        dt.preferences.set("segmentation/precision", "float32")
        model = config4_model(params)
        B, S = model.batch_size, KNEE_SHAPE[2]
        blocks = params["down"] + params["up"] + [{"final": params["final"]}]
        n_params = sum(a.size for blk in blocks for layer in blk.values() for a in layer.values())
        print(f"phase 10 data: {KNEE_SHAPE} float32 knee (RandomState(4)), full-width U-Net "
              f"({n_params:,} parameters, RandomState(0)), batch {B}, in "
              f"{time.perf_counter() - t0:.2f} s (host)")
        cats = model.CATEGORIES

        t0 = time.perf_counter()
        reset_launches()
        masks = model.generate_mask(host)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = expect_launches("segmentation")  # no hand kernel on this path
        for c in cats:
            v = masks[c]
            check(isinstance(v.volume, np.ndarray) and v.volume.dtype == np.uint8
                  and v.shape == KNEE_SHAPE and v.orientation == host.orientation,
                  f"mask {c}: {type(v.volume)} {v.volume.dtype} {v.shape} {v.orientation}")

        # The card's float32 probabilities of the batches that hold the check
        # slices, computed as predict_mask_volume computes them.
        net = model.seg_model.network(dev)
        x = torch.from_numpy(arr).to(dev)
        mean, std = x.mean(), x.std(correction=0)
        slices = x.permute(2, 0, 1).contiguous()[:, None]

        def batch_probs(network, b0, dtype=torch.float32):
            with torch.inference_mode(), cudnn_exact():
                xs = (slices[b0 : b0 + B].to(torch.float32) - mean) / std
                return network(xs.to(dtype)).to(torch.float32)

        starts = sorted({s - s % B for s in SEG_CHECK_SLICES})
        probs = {b0: batch_probs(net, b0) for b0 in starts}
        check(torch.backends.cudnn.allow_tf32 is True, "the forward left allow_tf32 changed")

        # Check 1: full float32 against float64 on the CPU, same weights.
        a64 = arr.astype(np.float64)
        x64 = (a64[..., list(SEG_CHECK_SLICES)] - a64.mean()) / a64.std()
        t0 = time.perf_counter()
        net64 = UNet2D.from_params(params).double()
        with torch.inference_mode():
            p64 = net64(torch.from_numpy(np.ascontiguousarray(x64.transpose(2, 0, 1)))[:, None])
        ref_s = time.perf_counter() - t0
        p32 = torch.stack([probs[s - s % B][s % B] for s in SEG_CHECK_SLICES]).double().cpu()
        f32_err = float((p32 - p64).abs().max())
        flips = (p32 > 0.5) != (p64 > 0.5)
        check(f32_err <= SEG_F32_TOL, f"float32 probabilities {f32_err:.3g} from float64 "
              f"(tolerance {SEG_F32_TOL}): TF32 reached the convolutions?")
        check(bool(((p64[flips] - 0.5).abs() <= SEG_F32_TOL).all()),
              "a float32 mask differs from float64 away from p = 0.5")
        print(f"phase 10 check 1: card float32 vs CPU float64 on slices {SEG_CHECK_SLICES}, "
              f"allow_tf32 True: max|Δp| {f32_err:.3g} (tolerance {SEG_F32_TOL}), "
              f"{int(flips.sum())} mask flips, all within it of 0.5; reference {ref_s:.2f} s")

        # Check 2: the packed path is lossless, reformat back included.
        for s in SEG_CHECK_SLICES:
            want = (probs[s - s % B][s % B] > 0.5).to(torch.uint8).cpu().numpy()  # (C, H, W)
            for ci, c in enumerate(cats):
                check(np.array_equal(masks[c].volume[:, :, s], want[ci]),
                      f"generate_mask {c} slice {s} differs from the card's probabilities")
        share = {c: float(masks[c].volume.mean()) for c in cats}
        print(f"phase 10 check 2: generate_mask equals the card's thresholded probabilities "
              f"on slices {SEG_CHECK_SLICES} for {cats}; foreground shares {share}")

        # Check 3: the same masks for a volume already on the card.
        on_card = host.to(dev)
        masks_card = model.generate_mask(on_card)
        for c in cats:
            n_diff = int((masks_card[c].volume != masks[c].volume).sum())
            check(n_diff == 0, f"mask {c} of the card volume differs from the host volume's "
                               f"on {n_diff} voxels")
        print("phase 10 check 3: the card volume gives the host volume's masks")

        # Check 4: one packed device-to-host copy a call.
        packed = int(np.prod(KNEE_SHAPE)) * 4 // 8
        moved, n_copies = d2h_bytes(lambda: model.generate_mask(host))
        check(packed <= moved <= packed + 1024,
              f"D2H {moved} bytes in one call, not the packed mask's {packed} + scalars")
        moved_card, _ = d2h_bytes(lambda: model.generate_mask(on_card))
        check(packed <= moved_card <= packed + 1024,
              f"D2H {moved_card} bytes for the card volume, not {packed} + scalars")
        print(f"phase 10 check 4: D2H {moved:,} bytes in {n_copies} copies a call, "
              f"{moved_card:,} for the card volume (packed mask {packed:,}; float32 "
              f"probabilities would be {4 * 4 * int(np.prod(KNEE_SHAPE)):,})")

        # Times (float32).
        wall_s, walls = median_wall(lambda: model.generate_mask(host))
        wall_card_s, walls_card = median_wall(lambda: model.generate_mask(on_card))
        _, busy_ms, idle = device_busy_share(lambda: model.generate_mask(host))
        torch.cuda.reset_peak_memory_stats()
        model.generate_mask(host)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()

        def forward_ms(network, dtype):
            per = []
            for b0 in range(0, S, B):
                ms, _ = time_ms(lambda: batch_probs(network, b0, dtype), reps=3)
                per.append(ms)
            return per

        fwd = forward_ms(net, torch.float32)
        # Levers the port does not take (PERF.md): the same float32 forward
        # with activations and weights channels_last, and with cuDNN free to
        # pick non-deterministic algorithms.
        net_cl = UNet2D.from_params(params).to(dev).to(memory_format=torch.channels_last)
        with torch.inference_mode():
            slices_cl = slices.contiguous(memory_format=torch.channels_last)
        fwd_cl = []
        for b0 in range(0, S, B):
            def cl_batch(b0=b0):
                with torch.inference_mode(), cudnn_exact():
                    return net_cl((slices_cl[b0 : b0 + B] - mean) / std)
            fwd_cl.append(time_ms(cl_batch, reps=3)[0])
        prev_det = torch.backends.cudnn.deterministic
        fwd_nondet = []
        for b0 in range(0, S, B):
            def nondet_batch(b0=b0):
                with torch.inference_mode(), cudnn_exact():
                    torch.backends.cudnn.deterministic = False
                    return net((slices[b0 : b0 + B] - mean) / std)
            fwd_nondet.append(time_ms(nondet_batch, reps=3)[0])
        torch.backends.cudnn.deterministic = prev_det
        del net_cl, slices_cl
        # The host's share: unpacking the packed bytes of one call.
        packed_host = np.random.RandomState(1).randint(
            0, 256, (S, KNEE_SHAPE[0], KNEE_SHAPE[1] // 2), dtype=np.uint8)
        t0 = time.perf_counter()
        unpack(packed_host, KNEE_SHAPE[1], 4, 4)
        unpack_s = time.perf_counter() - t0
        flops = unet_flops(KNEE_SHAPE[0], KNEE_SHAPE[1], FEATURES, 4) * S
        bound_f32 = flops / PEAK_F32_PER_S * 1e3
        bound_bf16 = flops / PEAK_BF16_PER_S * 1e3

        # Check 5: bfloat16.
        dt.preferences.set("segmentation/precision", "bfloat16")
        model16 = IWOAIOAIUnet2DNormalized((KNEE_SHAPE[0], KNEE_SHAPE[1], 1), None,
                                           force_weights=True)
        model16.seg_model.params = params
        masks16 = model16.generate_mask(host)
        net16 = model16.seg_model.network(dev)
        bf16_err = max(float((batch_probs(net16, b0, torch.bfloat16) - probs[b0]).abs().max())
                       for b0 in starts)
        differ = sum(int((masks16[c].volume != masks[c].volume).sum()) for c in cats)
        differ_share = differ / (4 * int(np.prod(KNEE_SHAPE)))
        check(bf16_err <= SEG_BF16_MAX_ABS_ERR,
              f"bfloat16 max|Δp| {bf16_err:.4g} > {SEG_BF16_MAX_ABS_ERR}")
        check(differ_share <= SEG_BF16_MASK_SHARE,
              f"bfloat16 masks differ on {differ_share:.4g} of voxels > {SEG_BF16_MASK_SHARE}")
        wall16_s, walls16 = median_wall(lambda: model16.generate_mask(host))
        fwd16 = forward_ms(net16, torch.bfloat16)
        print(f"phase 10 check 5: bfloat16 vs float32: max|Δp| {bf16_err:.4g} on {len(starts)} "
              f"batches (bound {SEG_BF16_MAX_ABS_ERR}), masks differ on {differ:,} voxels, "
              f"{differ_share:.4g} of them (bound {SEG_BF16_MASK_SHARE})")

        print(f"phase 10 on {card}, {S} slices of {KNEE_SHAPE[0]}x{KNEE_SHAPE[1]}, batch {B}:")
        print(f"  generate_mask warm wall (median of 3): host volume {wall_s:.4f} s "
              f"({S / wall_s:.1f} slices/s; {[round(w, 4) for w in walls]}), card volume "
              f"{wall_card_s:.4f} s ({S / wall_card_s:.1f} slices/s; "
              f"{[round(w, 4) for w in walls_card]}); first call {first_s:.3f} s")
        print(f"  forward alone (CUDA events, median of 3 a batch): float32 {sum(fwd):.3f} ms "
              f"({[round(t, 3) for t in fwd]}), {S / sum(fwd) * 1e3:.1f} slices/s; bfloat16 "
              f"{sum(fwd16):.3f} ms ({[round(t, 3) for t in fwd16]})")
        print(f"  bound: {flops / 1e12:.3f} TFLOP of convolutions ({flops / S / 1e9:.2f} GFLOP "
              f"a slice) over the float32 rate 67 TFLOP/s = {bound_f32:.3f} ms (operations; "
              f"float32 share {bound_f32 / sum(fwd):.3f}); over bfloat16's dense 989 TFLOP/s "
              f"= {bound_bf16:.3f} ms (share {bound_bf16 / sum(fwd16):.3f})")
        print(f"  levers not taken, float32 forward: channels_last {sum(fwd_cl):.3f} ms "
              f"({[round(t, 3) for t in fwd_cl]}); non-deterministic cuDNN algorithms "
              f"{sum(fwd_nondet):.3f} ms ({[round(t, 3) for t in fwd_nondet]}); the host's "
              f"np.unpackbits of one call's packed mask {unpack_s * 1e3:.3f} ms")
        print(f"  card busy in one call {busy_ms:.3f} ms, idle share {idle:.4f}; bfloat16 "
              f"generate_mask {wall16_s:.4f} s ({[round(w, 4) for w in walls16]}); peak memory "
              f"{peak / 2**30:.3f} GiB")
        return {"shape": list(KNEE_SHAPE), "batch_size": B, "launches": launches,
                "wall_s": wall_s, "wall_card_s": wall_card_s, "first_s": first_s,
                "slices_per_s": S / wall_s, "slices_per_s_card": S / wall_card_s,
                "forward_ms": sum(fwd), "forward_batch_ms": fwd,
                "bound_ms": bound_f32, "bound_by": "operations", "tflop": flops / 1e12,
                "busy_ms": busy_ms, "idle_share": idle, "d2h_bytes": moved,
                "d2h_bytes_card": moved_card,
                "f32_max_abs_err": f32_err, "bf16_max_abs_err": bf16_err,
                "bf16_mask_differ_share": differ_share, "bf16_wall_s": wall16_s,
                "bf16_forward_ms": sum(fwd16), "bf16_bound_ms": bound_bf16,
                "peak_bytes": peak, "forward_channels_last_ms": sum(fwd_cl),
                "forward_nondeterministic_ms": sum(fwd_nondet), "unpack_ms": unpack_s * 1e3}, model
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
        dt.preferences.set("segmentation/precision", prev_precision)


# ----------------------------------------------------------------------
# Phase 11: the qDESS knee, from a DICOM series to per-region T2 rows
# ----------------------------------------------------------------------
QDESS_ECHO_TIMES = (8.0, 42.0)  # tests/scan_sequences/mri/test_qdess.py's echoes
QDESS_RATIO = (0.2, 0.6)  # echo 2 = echo 1 x a ratio drawn from RandomState(5)
QDESS_RTOL = 1e-9  # rows and unrolled maps, card map against its host copy
D2H_SLACK = 1 << 20  # bytes beyond 8 a masked voxel the compressed analytics may copy


def qdess_headers(shape, physics):
    """(1, 1, slices, 2) headers of a two-echo sagittal qDESS series
    (``parallel/dryrun.py::series_headers``) with TR, the flip angle and
    GE's private spoiler tags (0019,10B6) / (0019,10B7) set."""
    from dosma_tpu_torch.core.io.dicom import Tag
    from dosma_tpu_torch.parallel.dryrun import series_headers

    headers = series_headers(shape, SEG_SPACING, QDESS_ECHO_TIMES)
    for ds in headers.flat:
        ds.RepetitionTime = physics["tr"]
        ds.FlipAngle = physics["alpha"]
        ds[Tag(0x0019, 0x10B6)] = physics["gl_area"]
        ds[Tag(0x0019, 0x10B7)] = physics["tg"]
    return headers


def condyle_arc(shape):
    """bench.py:544-553: the inferior arc of a femoral condyle in each
    sagittal slice, the geometry the femoral analytics expect."""
    h, w, d = shape
    yv, xv = np.mgrid[0:h, 0:w]
    cy, cx, R = h * 0.45, w * 0.5, h * 0.3
    rad = np.sqrt((yv - cy) ** 2 + (xv - cx) ** 2)
    annulus = (rad > R * 0.8) & (rad < R * 1.05) & (yv > cy)
    return np.repeat(annulus[..., None], d, axis=2).astype(np.uint8)


def check_tissue_rows(name, card, host, rtol=QDESS_RTOL):
    """``quant_rows`` of the card map against the host copy's: categories and
    voxel counts exactly, statistics and unrolled maps within ``rtol`` with
    equal NaN positions. Returns the largest relative difference."""
    (header, rows, maps), (header_h, rows_h, maps_h) = card, host
    check(header == header_h, f"{name}: header {header} vs {header_h}")
    stats = {i for i, col in enumerate(header) if col in ("Mean", "Std", "Median")}
    worst = 0.0
    for r, w in zip(rows, rows_h, strict=True):
        check([v for i, v in enumerate(r) if i not in stats]
              == [v for i, v in enumerate(w) if i not in stats],
              f"{name}: row {r} differs from the host map's {w} in its categories or counts")
        for i in stats:
            a, b = float(r[i]), float(w[i])
            check(np.isnan(a) == np.isnan(b), f"{name}: {header[i]} {a} vs {b}")
            if not np.isnan(b):
                rel = abs(a - b) / max(abs(b), 1e-300)
                check(rel <= rtol, f"{name}: {r[:4]} {header[i]} {a} vs {b} (rel {rel:.3g})")
                worst = max(worst, rel)
    for m, mh in zip(maps, maps_h, strict=True):
        a, b = np.asarray(m["data"], np.float64), np.asarray(mh["data"], np.float64)
        check(a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b)),
              f"{name}: unrolled map {m['title']} shape or NaN positions differ")
        fin = ~np.isnan(b)
        if fin.any():
            rel = float((np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1e-300)).max())
            check(rel <= rtol, f"{name}: unrolled map {m['title']} rel {rel:.3g}")
            worst = max(worst, rel)
    return worst


def asked_d2h_bytes(fn):
    """Bytes of card tensors that ``fn`` asks to have on the host (``cpu``,
    ``to`` the CPU, ``tolist``, ``item``), counted at those calls: a second
    count beside the profiler's memcpy events, which a process that has run
    many profiler sessions may miss (PERF.md §5)."""
    counted = [0]
    originals = {name: getattr(torch.Tensor, name) for name in ("cpu", "to", "tolist", "item")}

    def counting(name):
        original = originals[name]

        def call(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            if self.is_cuda and (name in ("tolist", "item") or not out.is_cuda):
                counted[0] += self.numel() * self.element_size()
            return out
        return call

    for name in originals:
        setattr(torch.Tensor, name, counting(name))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for name, original in originals.items():
            setattr(torch.Tensor, name, original)
    return counted[0]


@functools.lru_cache(maxsize=None)
def qdess_knee_series():
    """Phase 11's two-echo knee: (pixels (384, 384, 160, 2) uint16, headers,
    affine); made once a process (phase 14 writes it again)."""
    from dosma_tpu_torch.core.io.dicom_io import to_RAS_affine

    physics = {k: QDESS_PHYSICS[k] for k in ("tr", "alpha", "gl_area", "tg")}
    e1 = (np.random.RandomState(4).rand(*KNEE_SHAPE) * 1000).astype(np.uint16)
    ratio = np.random.RandomState(5).uniform(*QDESS_RATIO, KNEE_SHAPE)
    e2 = (e1 * ratio).astype(np.uint16)
    headers = qdess_headers(KNEE_SHAPE, physics)
    return np.stack([e1, e2], axis=-1), headers, to_RAS_affine(list(headers[0, 0, :, 0]))


def phase_qdess_knee(dt, dev, card, model=None):
    """Phase 11 (see the module docstring): a two-echo qDESS series of the
    OAI DESS matrix from DICOM to every knee tissue's rows on the card."""
    from dosma_tpu_torch.core.io.dicom_io import to_RAS_affine
    from dosma_tpu_torch.core.orientation import SAGITTAL
    from dosma_tpu_torch.ops.qmri import qdess_t2_map
    from dosma_tpu_torch.tissues import largest_cc

    if model is None:  # phase 11 alone: the same model as phase 10's
        from dosma_tpu_torch.models.unet2d import FEATURES

        model = config4_model(he_normal_unet_params(np.random.RandomState(0), 4, FEATURES))
    physics = {k: QDESS_PHYSICS[k] for k in ("tr", "alpha", "gl_area", "tg")}
    t0 = time.perf_counter()
    pixels, headers, affine = qdess_knee_series()
    print(f"phase 11 data: two echoes of {KNEE_SHAPE} uint16 (RandomState(4) x 1000, echo 2 x "
          f"U{QDESS_RATIO} from RandomState(5)), {pixels.nbytes / 1e6:.1f} MB of pixels, in "
          f"{time.perf_counter() - t0:.2f} s (host)")

    def tissues():
        return [dt.FemoralCartilage(), dt.TibialCartilage(), dt.PatellarCartilage(),
                dt.Meniscus()]

    work = tempfile.mkdtemp(prefix="chip_smoke_qdess_")
    try:
        series_dir = os.path.join(work, "series")
        t0 = time.perf_counter()
        dt.DicomWriter(num_workers=8).save(dt.MedicalVolume(pixels, affine, headers=headers),
                                           series_dir)
        write_s = time.perf_counter() - t0
        n_files = len(os.listdir(series_dir))
        check(n_files == 2 * KNEE_SHAPE[2], f"{n_files} files written, not {2 * KNEE_SHAPE[2]}")
        print(f"phase 11 write: DicomWriter(num_workers=8) {n_files} files in {write_s:.3f} s")

        # 1. from_dicom, host and card: the same pixels and header values.
        host_scan = dt.QDess.from_dicom(series_dir, num_workers=8)
        scan = dt.QDess.from_dicom(series_dir, to_device=True, num_workers=8)
        for e, (h, c) in enumerate(zip(host_scan.volumes, scan.volumes, strict=True)):
            check(h.A.dtype == np.uint16 and np.array_equal(h.A, pixels[..., e]),
                  f"host read: echo {e + 1} pixels")
            want = torch.from_numpy(pixels[..., e]).to(dev).to(torch.int32)
            check(c.A.device == want.device and c.A.dtype == torch.int32
                  and torch.equal(c.A, want), f"from_dicom(to_device=True): echo {e + 1} pixels")
            check(np.array_equal(c.affine, affine), f"echo {e + 1} affine")
        from dosma_tpu_torch.core.io.dicom import Tag
        for s in (host_scan, scan):
            check(float(s.get_metadata(Tag(0x0019, 0x10B6))) == physics["gl_area"]
                  and float(s.get_metadata(Tag(0x0019, 0x10B7))) == physics["tg"],
                  "the private spoiler tags did not survive DicomWriter -> reader")
        orientation = scan.volumes[0].orientation
        print(f"phase 11 read: 2 echoes of {KNEE_SHAPE}, orientation {orientation}, pixels equal "
              f"(uint16 on the host, int32 on the card), (0019,10B6) / (0019,10B7) = "
              f"{physics['gl_area']} / {physics['tg']} in both")

        # 2. segment on the echoes' RSS into the four tissues.
        reset_launches()
        tis = tissues()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = scan.segment(model, tis, use_rss=True)
        first_segment_s = time.perf_counter() - t0
        ref = model.generate_mask(scan.calc_rss())
        cc_rule = {"fc": True, "tc": False, "pc": True, "men": False}  # each set_mask's default
        for t in tis:
            m = ref[t.STR_ID]
            check(np.array_equal(masks[t.STR_ID].A, m.A), f"segment's {t.STR_ID} mask differs "
                  "from model.generate_mask(scan.calc_rss())")
            want = largest_cc(m.A) if cc_rule[t.STR_ID] else m.A
            got = t.get_mask()
            check(got.orientation == SAGITTAL and np.array_equal(
                got.A, dt.MedicalVolume(np.asarray(want, np.uint8), m.affine)
                .reformat(SAGITTAL).A), f"{t.STR_ID}'s mask is not its channel of the model's")
        share = {t.STR_ID: float(ref[t.STR_ID].A.mean()) for t in tis}
        print(f"phase 11 segment: use_rss=True, each tissue's mask equals its channel of "
              f"model.generate_mask(scan.calc_rss()) (largest_cc for fc and pc), in SAGITTAL; "
              f"foreground shares {share}; first call {first_segment_s:.3f} s")

        # 3. the condyle arc on every tissue; 4. the T2 map of each, on the card.
        arc = dt.MedicalVolume(condyle_arc(KNEE_SHAPE), affine)
        n_arc = int(arc.A.sum())
        for t in tis:
            if isinstance(t, (dt.FemoralCartilage, dt.PatellarCartilage)):
                t.set_mask(arc, use_largest_cc=False)
            else:
                t.set_mask(arc)
        e1_card, e2_card = (v.A for v in scan.volumes)
        results = {}
        for t in tis:
            qv = scan.generate_t2_map(tissue=t)
            vm = qv.volumetric_map
            check(isinstance(vm.A, torch.Tensor) and vm.A.device == dev,
                  f"{t.STR_ID}: the T2 map of card echoes is not on the card")
            plain = qdess_t2_map(e1_card, e2_card, te=QDESS_ECHO_TIMES[0], t1=t.T1_EXPECTED,
                                 **physics)
            plain = dt.MedicalVolume(plain, affine).reformat(vm.orientation).A
            check(torch.equal(vm.A, plain), f"{t.STR_ID}: generate_t2_map differs from "
                  "qdess_t2_map of the same echoes with the header's parameters")
            host_map = vm.cpu()
            card_rows = t.quant_rows(vm, qv.qv_type)
            host_rows = t.quant_rows(host_map, qv.qv_type)
            results[t.STR_ID] = {"rel": check_tissue_rows(t.STR_ID, card_rows, host_rows),
                                 "rows": len(card_rows[1])}
        print(f"phase 11 T2 maps: bit-equal to ops.qmri.qdess_t2_map of the card echoes "
              f"(TR {physics['tr']}, TE {QDESS_ECHO_TIMES[0]}, alpha {physics['alpha']}, "
              f"gl_area {physics['gl_area']}, tg {physics['tg']}, each tissue's T1)")
        print(f"phase 11 rows: the condyle arc ({n_arc:,} voxels) on every tissue; the card "
              f"map's rows and unrolled maps against its host copy's: categories and counts "
              f"equal, largest rel {max(r['rel'] for r in results.values()):.3g} (tolerance "
              f"{QDESS_RTOL:g}); rows {{{', '.join(f'{k}: {v['rows']}' for k, v in results.items())}}}")
        for t in tis:
            header, rows, _ = t.quant_rows(t.quantitative_values[0].volumetric_map,
                                           t.quantitative_values[0].qv_type)
            print(f"  phase 11 {t.STR_ID} rows:", json.dumps(
                [dict(zip(header, r)) for r in rows[:2]] + [dict(zip(header, rows[-1]))],
                default=float))

        # D2H of each tissue's analytics (the map is 4 bytes a voxel), by the
        # profiler's memcpy events and by the copies the code asks for.
        d2h, d2h_asked = {}, {}
        for t in tis:
            qv = t.quantitative_values[0]

            def rows(t=t, qv=qv):
                return t.quant_rows(qv.volumetric_map, qv.qv_type)

            d2h[t.STR_ID] = d2h_bytes(rows)[0]
            d2h_asked[t.STR_ID] = asked_d2h_bytes(rows)
        limit = 8 * n_arc + D2H_SLACK
        for k in d2h:
            for source, nbytes in (("memcpy events", d2h[k]), ("asked", d2h_asked[k])):
                check(nbytes <= limit, f"{k}: analytics copied {nbytes} bytes to the host "
                      f"({source}), more than 8 a masked voxel + 1 MB ({limit})")
        map_bytes = 4 * int(np.prod(KNEE_SHAPE))
        print(f"phase 11 D2H of one analytics call: profiler memcpy events {d2h} bytes, copies "
              f"asked for {d2h_asked} bytes; each within 8 x {n_arc:,} masked voxels + 1 MB = "
              f"{limit:,}; the map is {map_bytes:,}")

        # Warm walls, each the median of 3.
        def dir_to_rows():
            s = dt.QDess.from_dicom(series_dir, to_device=True, num_workers=8)
            ts = tissues()
            s.segment(model, ts, use_rss=True)
            out = []
            for t in ts:
                t.set_mask(arc, **({"use_largest_cc": False}
                                   if isinstance(t, (dt.FemoralCartilage, dt.PatellarCartilage))
                                   else {}))
                qv = s.generate_t2_map(tissue=t)
                out.append(t.quant_rows(qv.volumetric_map, qv.qv_type))
            return out

        reset_launches()
        wall_s, walls = median_wall(dir_to_rows)
        launches = expect_launches("qDESS knee")  # no hand kernel on this path
        prof_wall_s, busy_ms, idle = device_busy_share(dir_to_rows)
        torch.cuda.reset_peak_memory_stats()
        dir_to_rows()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        read_s, _ = median_wall(lambda: dt.QDess.from_dicom(series_dir, num_workers=8))
        load_s, _ = median_wall(lambda: dt.QDess.from_dicom(series_dir, to_device=True,
                                                            num_workers=8))

        def segment_once():
            scan.tissues = []
            scan.segment(model, tissues(), use_rss=True)

        segment_s, _ = median_wall(segment_once)
        t2_s, _ = median_wall(lambda: scan.generate_t2_map(t1=1200.0))
        fc_mask = ref["fc"].A
        cc_s, _ = median_wall(lambda: largest_cc(fc_mask))
        cc_arc_s, _ = median_wall(lambda: largest_cc(arc.A))
        analytics = {}
        for t in tis:
            qv = t.quantitative_values[0]
            analytics[t.STR_ID] = median_wall(
                lambda t=t, qv=qv: t.quant_rows(qv.volumetric_map, qv.qv_type))[0]
        set_mask_s = {}
        for t in tissues():
            kw = ({"use_largest_cc": False}
                  if isinstance(t, (dt.FemoralCartilage, dt.PatellarCartilage)) else {})
            set_mask_s[t.STR_ID] = median_wall(lambda t=t, kw=kw: t.set_mask(arc, **kw))[0]
        ms = {k: round(v * 1e3, 3) for k, v in analytics.items()}
        print(f"phase 11 on {card}, {KNEE_SHAPE} x 2 echoes, config4's model at full width:")
        print(f"  DICOM directory -> every tissue's rows (from_dicom(to_device=True), segment, "
              f"the arc masks, generate_t2_map and quant_rows for each tissue), warm, median "
              f"of 3: {wall_s:.4f} s, runs {[round(w, 4) for w in walls]}; one more run under "
              f"torch.profiler: wall {prof_wall_s:.4f} s, the card busy {busy_ms:.3f} ms, idle "
              f"share {idle:.4f}; launches {launches}")
        print(f"  from_dicom: host read {read_s:.4f} s, to_device=True {load_s:.4f} s")
        print(f"  segment (RSS, generate_mask, set_mask of four tissues): {segment_s:.4f} s; "
              f"largest_cc of the fc mask {cc_s * 1e3:.3f} ms, of the arc {cc_arc_s * 1e3:.3f} ms")
        print(f"  generate_t2_map (card echoes): {t2_s * 1e3:.3f} ms")
        print(f"  set_mask of the arc (region split, host): "
              f"{ {k: round(v * 1e3, 3) for k, v in set_mask_s.items()} } ms")
        print(f"  analytics (quant_rows on the card map): {ms} ms")
        print(f"  peak memory allocated in one run {peak / 2**30:.3f} GiB")
        return {"shape": list(KNEE_SHAPE), "masked_voxels": n_arc, "launches": launches,
                "wall_s": wall_s, "busy_ms": busy_ms, "idle_share": idle,
                "read_s": read_s, "from_dicom_to_device_s": load_s, "segment_s": segment_s,
                "t2_map_ms": t2_s * 1e3, "largest_cc_fc_ms": cc_s * 1e3,
                "largest_cc_arc_ms": cc_arc_s * 1e3,
                "set_mask_ms": {k: v * 1e3 for k, v in set_mask_s.items()},
                "analytics_ms": {k: v * 1e3 for k, v in analytics.items()},
                "d2h_bytes": d2h, "d2h_bytes_asked": d2h_asked, "peak_bytes": peak,
                "rows_max_rel": max(r["rel"] for r in results.values())}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 12: the registered scans, from a DICOM series to T1ρ / T2 / T2* maps
# ----------------------------------------------------------------------
SCAN_SPACING = (0.5, 0.5, 1.0)  # bench.py:379 (config 3's voxels, sagittal)
SPIN_LOCK_TIMES = (1.0, 10.0, 30.0, 60.0)  # bench.py:380
CQ_TARGET_SHIFT = (3, -2, 1)  # the target: the first spin lock rolled by this
SCAN_SMALL_SHAPE = (192, 192, 48)  # config 3's own size, for MAPSS and Cones
MAPSS_TIMES = (1.0, 10.0, 40.0, 80.0, 10.0, 30.0, 50.0)
MAPSS_SHIFT = (1, -1, 0)  # echoes 1-6 rolled by this
CONES_TIMES = (0.5, 2.0, 5.0, 10.0)
CONES_TARGET_SHIFT = (2, -1, 1)  # the target: the last echo rolled by this
RECOVERY_GATE = 0.5  # voxel, largest corner displacement (phase 7's)


def relaxometry_volumes(shape, times, seed=3):
    """bench.py:379-391 (config 3): relaxation times U(20, 100) ms, a bright
    box of 1000 plus 50 U(0, 1), signal t = box * exp(-t / T). Returns the
    float32 volumes and the box's slices."""
    rs = np.random.RandomState(seed)
    relax = rs.rand(*shape).astype(np.float32) * 80 + 20
    base = np.zeros(shape, np.float32)
    box = (slice(shape[0] // 4, -(shape[0] // 4)), slice(shape[1] // 4, -(shape[1] // 4)),
           slice(2, -2))
    base[box] = 1000.0
    base += 50.0 * rs.rand(*shape).astype(np.float32)
    return [base * np.exp(-t / relax) for t in times], box


class recorded_calls:
    """Records each call of ``module.name`` (arguments and result) while
    the block runs; the call itself goes through unchanged, so the launch
    counts stay the path's own."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.original = getattr(self.module, self.name)

        def record(*args, **kwargs):
            out = self.original(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out
        setattr(self.module, self.name, record)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def check_recorded_warp(name, call):
    """A recorded ``warp_grid_batched`` call: its kernel output against the
    plain version on the same sources and maps (phase 3's tolerance).
    Returns (max |Δ|, bit-equal, the prepared sources, B, shape, order)."""
    from dosma_tpu_torch.ops.warp import prepare_sources, warp_grid_reference

    (vols, B, out_shape, order), _kw, out = call
    srcs = prepare_sources(vols, order)
    Bt = torch.as_tensor(B, dtype=torch.float32, device=vols.device)
    ref = warp_grid_reference(srcs, Bt, tuple(out_shape), order)
    torch.cuda.synchronize()
    err, equal = compare_warp(name, out, ref)
    del ref
    return err, equal, srcs, Bt, tuple(out_shape), order


def check_recorded_fit(name, call):
    """A recorded ``monoexp_lm`` call: the kernel's output against the
    plain version on the same inputs, every voxel (phase 4's tolerance)."""
    from dosma_tpu_torch.ops.monoexp import monoexp_lm_reference

    args, kwargs, out = call
    ref = monoexp_lm_reference(*args, **kwargs)
    torch.cuda.synchronize()
    return compare(name, out, ref)


def transform_matrix(directory):
    """The composition of the transform files of ``directory``, and their paths."""
    from dosma_tpu_torch.core.registration import _load_transform_file
    from dosma_tpu_torch.ops.registration import compose_transforms

    files = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                   if f.startswith("TransformParameters."))
    return compose_transforms([np.asarray(_load_transform_file(f)["matrix"])
                               for f in files]), files


class utilization_sampler:
    """The card's busy share over a block: nvidia-smi's utilization.gpu (the
    share of each sample period in which a kernel ran), sampled every 200
    ms by one nvidia-smi process, stopped when the block ends. A trace of
    the Adam loops' millions of kernels would cost more than the run."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
             "-lms", "200", "-i", "0"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = [float(v) for v in out.split() if re.fullmatch(r"\d+(\.\d+)?", v)]
        self.samples = len(vals)
        self.busy = float(np.mean(vals)) / 100.0 if vals else float("nan")


def scipy_parity_monoexp(name, x, yT, tc_map, idx, bounds):
    """Relative RMSE of the map's tc at voxels ``idx`` against per-voxel
    scipy fits of a * exp(b x) to the same (registered) float32 echoes."""
    import scipy.optimize as sop

    idx_t = torch.from_numpy(idx).to(yT.device)
    Y = yT[:, idx_t].T.cpu().numpy().astype(np.float64)
    ours = tc_map.reshape(-1)[idx_t].cpu().numpy().astype(np.float64)
    ref = np.empty(len(idx))
    for j in range(len(idx)):
        pb = sop.curve_fit(lambda t, a, b: a * np.exp(b * t), np.float64(x), Y[j],
                           p0=(Y[j, 0], -1 / 50.0), maxfev=2000)[0]
        ref[j] = -1.0 / pb[1]
    use = (ours > 0) & (ref > bounds[0]) & (ref < bounds[1])
    check(use.mean() > 0.95, f"{name} parity: only {use.mean():.4f} of sampled voxels kept")
    rel = float(np.sqrt(np.mean(((ours[use] - ref[use]) / ref[use]) ** 2)))
    print(f"scipy parity {name}: rel RMSE of tc {rel:.6g} over {int(use.sum())} voxels "
          f"(gate {PARITY_GATE})")
    check(rel < PARITY_GATE, f"{name} scipy parity rel RMSE {rel}")
    return rel


def phase_cubequant(dt, dev, card):
    """Phase 12, CubeQuant: a 4-spin-lock series of the OAI DESS matrix from
    DICOM to femoral cartilage's T1ρ rows on the card."""
    from dosma_tpu_torch.core.io.dicom_io import to_RAS_affine
    from dosma_tpu_torch.ops import interp
    from dosma_tpu_torch.ops import monoexp_pipeline, registration
    from dosma_tpu_torch.ops.warp import warp_grid
    from dosma_tpu_torch.parallel.dryrun import series_headers

    shape = KNEE_SHAPE
    t0 = time.perf_counter()
    sigs, box = relaxometry_volumes(shape, SPIN_LOCK_TIMES)
    pixels = np.stack([np.rint(np.roll(v, (i, -i, 0), axis=(0, 1, 2)) if i else np.rint(v))
                       .astype(np.uint16) for i, v in enumerate(sigs)], axis=-1)
    del sigs
    headers = series_headers(shape, SCAN_SPACING, SPIN_LOCK_TIMES)
    affine = to_RAS_affine(list(headers[0, 0, :, 0]))
    print(f"phase 12 data: config 3's recipe (bench.py:379-391, RandomState(3)) at {shape}, "
          f"spin locks {SPIN_LOCK_TIMES} ms, spin lock i rolled by (i, -i, 0), uint16, "
          f"{pixels.nbytes / 1e6:.1f} MB of pixels, in {time.perf_counter() - t0:.2f} s (host)")

    work = tempfile.mkdtemp(prefix="chip_smoke_cq_")
    util = None
    try:
        series_dir = os.path.join(work, "series")
        t0 = time.perf_counter()
        dt.DicomWriter(num_workers=8).save(dt.MedicalVolume(pixels, affine, headers=headers),
                                           series_dir)
        write_s = time.perf_counter() - t0
        n_files = len(os.listdir(series_dir))
        check(n_files == 4 * shape[2], f"{n_files} files written, not {4 * shape[2]}")
        target_path = os.path.join(work, "target.nii.gz")
        arc_path = os.path.join(work, "arc.nii.gz")
        target = np.roll(pixels[..., 0].astype(np.float32), CQ_TARGET_SHIFT, axis=(0, 1, 2))
        dt.MedicalVolume(target, affine).save_volume(target_path)
        arc = np.roll(condyle_arc(shape), CQ_TARGET_SHIFT, axis=(0, 1, 2))
        dt.MedicalVolume(arc, affine).save_volume(arc_path)
        arc_mv = dt.NiftiReader().load(arc_path)
        del pixels, target
        print(f"phase 12 write: DicomWriter(num_workers=8) {n_files} files in {write_s:.3f} s; "
              f"target (spin lock 1 rolled by {CQ_TARGET_SHIFT}) and the condyle arc rolled "
              f"the same way ({int(arc.sum()):,} voxels) as NIfTI")

        def femoral(mask):
            fc = dt.FemoralCartilage()
            fc.set_mask(mask, use_largest_cc=False)
            return fc

        # The checked run (a process's first): each step with its launches,
        # the card's busy share and the peak memory over the whole path.
        torch.cuda.reset_peak_memory_stats()
        util = utilization_sampler().__enter__()
        t_first = time.perf_counter()
        t0 = time.perf_counter()
        scan = dt.CubeQuant.from_dicom(series_dir, to_device=True, num_workers=8)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        check(scan.spin_lock_times == list(SPIN_LOCK_TIMES),
              f"spin-lock times {scan.spin_lock_times} from the headers")
        check(all(v.A.is_cuda and v.A.dtype == torch.int32 for v in scan.volumes),
              "from_dicom(to_device=True): the spin locks are not int32 on the card")
        scan.temp_path = os.path.join(work, "cq")
        steps, launches = {}, {}
        with recorded_calls(registration, "warp_grid_batched") as warps:
            reset_launches()
            t0 = time.perf_counter()
            scan.intraregister()
            torch.cuda.synchronize()
            steps["intraregister_s"] = time.perf_counter() - t0
            launches["intraregister"] = expect_launches("intraregister", warp_grid=1)
            pre_inter = list(scan.volumes)
            reset_launches()
            t0 = time.perf_counter()
            scan.interregister(target_path, arc_path)
            torch.cuda.synchronize()
            steps["interregister_s"] = time.perf_counter() - t0
            launches["interregister"] = expect_launches("interregister", warp_grid=1)
        fc = femoral(arc_mv)
        with recorded_calls(monoexp_pipeline, "monoexp_lm") as fits:
            reset_launches()
            t0 = time.perf_counter()
            qv = scan.generate_t1_rho_map(tissue=fc)
            torch.cuda.synchronize()
            steps["t1rho_fit_s"] = time.perf_counter() - t0
            launches["fit"] = expect_launches("generate_t1_rho_map", monoexp_lm=1)
        # The map in the fit's layout, and the parity voxels in it (the rows
        # reformat the map in place to the mask's orientation): inside the
        # box (3 voxels in from its edges, rolled onto the target grid) and
        # the arc.
        fit_map = qv.volumetric_map.A.clone()
        inside = np.zeros(shape, np.uint8)
        inside[tuple(slice(b.start + 3, b.stop - 3) for b in box)] = 1
        inside = np.roll(inside, CQ_TARGET_SHIFT, axis=(0, 1, 2)) & arc
        inside = dt.MedicalVolume(inside, affine).reformat_as(qv.volumetric_map).A
        t0 = time.perf_counter()
        rows = fc.quant_rows(qv.volumetric_map, qv.qv_type)
        steps["rows_s"] = time.perf_counter() - t0
        first_s = time.perf_counter() - t_first
        util.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated()
        path_launches = {"warp_grid": launches["intraregister"]["warp_grid"]
                         + launches["interregister"]["warp_grid"],
                         "monoexp_lm": launches["fit"]["monoexp_lm"]}
        vm = qv.volumetric_map
        check(isinstance(vm.A, torch.Tensor) and vm.A.is_cuda and vm.shape == shape
              and bool(torch.isfinite(vm.A).all()), "the T1ρ map is not a finite card volume")
        check(fc.quantitative_values and fc.quantitative_values[-1] is qv,
              "the T1ρ value was not added to the tissue")

        # 2. recovery, from the transform files written.
        intra_err = []
        for k, t in enumerate(SPIN_LOCK_TIMES[1:]):
            M, _ = transform_matrix(os.path.join(scan.temp_path, "intraregister", f"moving-{k}"))
            intra_err.append(corner_error_vox(M, affine, shape, ((k + 1), -(k + 1), 0)))
        M_inter, inter_files = transform_matrix(
            os.path.join(scan.temp_path, "interregistered", "moving-0"))
        inter_err = corner_error_vox(M_inter, affine, shape,
                                     tuple(-s for s in CQ_TARGET_SHIFT))
        print(f"phase 12 recovery (largest corner displacement against the known roll): "
              f"intraregister {[round(e, 4) for e in intra_err]} voxel, interregister "
              f"{inter_err:.4f} voxel (gate {RECOVERY_GATE})")
        check(max(intra_err) < RECOVERY_GATE, f"intraregister recovery {intra_err}")
        check(inter_err < RECOVERY_GATE, f"interregister recovery {inter_err}")

        # 3. the fit's kernel; 4. both warps' kernel, against their plain versions.
        check(len(fits) == 1 and len(warps) == 2, f"{len(fits)} fits, {len(warps)} warps")
        fit_err, fit_err_r2, fit_agree = check_recorded_fit("monoexp_lm T1ρ", fits[0])
        print(f"compare monoexp_lm T1ρ fit: kernel vs plain on every voxel ({shape}, 4 spin "
              f"locks): max|Δ| a,b={fit_err:.3g} r2={fit_err_r2:.3g}, converged agree "
              f"{fit_agree:.6f}")
        warp_res = {}
        for label, call in zip(("intraregister", "interregister"), warps):
            err, equal, srcs, B, out_shape, order = check_recorded_warp(
                f"warp_grid {label}", call)
            nb = int(srcs.shape[0])
            k_ms, k_all = time_ms(lambda: warp_grid(srcs, B, out_shape, order))
            nbytes, flops = warp_work(tuple(srcs.shape), out_shape, nb, order)
            b_ms, b_by = bound(nbytes, flops)
            warp_res[label] = {"nb": nb, "order": order, "max_abs_err": err, "bit_equal": equal,
                               "ms": k_ms, "bound_ms": b_ms, "bound_by": b_by}
            print(f"compare warp_grid {label}: NB={nb} order {order} {tuple(srcs.shape[1:])} -> "
                  f"{out_shape}, one map {'per volume' if B.ndim == 3 else 'for all'}: "
                  f"max|Δ|={err:.3g} bit-equal={equal}; kernel {k_ms:.4f} ms runs "
                  f"{[round(t, 4) for t in k_all]}, bound {b_ms:.4f} ms by {b_by}")
            del srcs
        del warps
        torch.cuda.empty_cache()

        # 5. scipy parity on 2,000 voxels inside the box and the arc.
        args = fits[0][0]
        x, yT = args[0], args[1]
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        idx = np.random.RandomState(2).choice(np.flatnonzero(inside.reshape(-1)), PARITY_N,
                                              replace=False)
        parity = scipy_parity_monoexp("T1ρ (phase 12)", x, yT, fit_map, idx, (0, 500))
        del fits, args, yT, fit_map

        # 6. fc's rows from the card map against its host copy.
        host_rows = fc.quant_rows(vm.cpu(), qv.qv_type)
        rows_rel = check_tissue_rows("fc T1ρ", rows, host_rows)
        print(f"phase 12 rows: fc's T1ρ rows on the card map against its host copy: "
              f"largest rel {rows_rel:.3g} (tolerance {QDESS_RTOL:g}); {len(rows[1])} rows")
        header, body, _ = rows
        print("  phase 12 fc rows:", json.dumps([dict(zip(header, r)) for r in body[:2]],
                                                default=float))

        # 7. the interregistered transform files warp the volumes again.
        back = dt.apply_warp(pre_inter, transform=inter_files)
        back_err = 0.0
        for i, (b, v) in enumerate(zip(back, scan.volumes, strict=True)):
            err, _eq = compare_warp(f"apply_warp of the interregister files, volume {i}",
                                    b.A, v.A)
            back_err = max(back_err, err)
        print(f"phase 12 transform files: apply_warp of {len(inter_files)} files to the 4 "
              f"intraregistered volumes gives the interregistered ones, max|Δ| {back_err:.3g}")
        del back, pre_inter, scan, qv, vm
        torch.cuda.empty_cache()

        # No warm rerun of the path (it took ~65 s): the first call's wall,
        # busy share, peak and launches stand for the path; one read each.
        host_read_s, _ = median_wall(lambda: dt.CubeQuant.from_dicom(series_dir, num_workers=8),
                                     reps=1)
        dev_read_s, _ = median_wall(lambda: dt.CubeQuant.from_dicom(series_dir, to_device=True,
                                                                    num_workers=8), reps=1)
        vol = torch.rand(shape, device=dev)
        pre_ms, _ = time_ms(lambda: interp.cubic_coeffs(vol))
        del vol
        intra_iters = 3 * 3 * 250  # 3 moving spin locks x 3 levels x 250 (affine preset)
        inter_iters = 2 * 3 * 250  # rigid + affine interregister presets
        inter_prefilters = 2 * 3  # order-3 metric sampling: one prefilter a level
        intra_ms_it = (steps["intraregister_s"] * 1e3 - warp_res["intraregister"]["ms"]) / intra_iters
        inter_ms_it = (steps["interregister_s"] * 1e3 - warp_res["interregister"]["ms"]
                       - inter_prefilters * pre_ms) / inter_iters
        print(f"phase 12 on {card}, CubeQuant at {shape} x 4 spin locks:")
        print(f"  DICOM directory -> fc's T1ρ rows (from_dicom(to_device=True), intraregister, "
              f"interregister(target, arc), generate_t1_rho_map(tissue=fc), quant_rows): first "
              f"call {first_s:.4f} s (no warm rerun); the card busy {util.busy:.4f} of it "
              f"(idle {1 - util.busy:.4f}; nvidia-smi utilization.gpu, {util.samples} samples "
              f"of 200 ms); peak memory allocated {peak / 2**30:.3f} GiB; launches "
              f"{path_launches}")
        print(f"  breakdown of the first call: from_dicom(to_device=True) {read_s:.4f} s "
              f"(warm: host read {host_read_s:.4f} s, to_device {dev_read_s:.4f} s); "
              f"intraregister {steps['intraregister_s']:.4f} s ({intra_iters} Adam iterations, "
              f"{intra_ms_it:.4f} ms each; final warp kernel "
              f"{warp_res['intraregister']['ms']:.4f} ms); interregister "
              f"{steps['interregister_s']:.4f} s ({inter_iters} iterations, {inter_ms_it:.4f} "
              f"ms each; {inter_prefilters} order-3 prefilters of {pre_ms:.4f} ms = "
              f"{inter_prefilters * pre_ms / 1e3 / steps['interregister_s']:.4f} of it; final "
              f"warp kernel {warp_res['interregister']['ms']:.4f} ms); T1ρ fit "
              f"{steps['t1rho_fit_s'] * 1e3:.3f} ms; fc's rows {steps['rows_s'] * 1e3:.3f} ms")
        return {"shape": list(shape), "launches": {k: v for k, v in launches.items()},
                "first_s": first_s, "busy_share": util.busy,
                "idle_share": 1 - util.busy, "peak_bytes": peak,
                "read_first_s": read_s, "host_read_s": host_read_s, "to_device_s": dev_read_s,
                **steps, "intraregister_ms_per_iteration": intra_ms_it,
                "interregister_ms_per_iteration": inter_ms_it, "prefilter_ms": pre_ms,
                "recovery_intra_vox": intra_err, "recovery_inter_vox": inter_err,
                "fit_max_abs_err": max(fit_err, fit_err_r2), "warps": warp_res,
                "scipy_parity": parity, "rows_max_rel": rows_rel, "apply_warp_max_abs": back_err}
    finally:
        if util is not None and util.proc.poll() is None:
            util.proc.kill()  # a check failed while the sampler ran
            util.proc.wait()
        shutil.rmtree(work, ignore_errors=True)


def phase_mapss_cones(dt, dev, card):
    """Phase 12, MAPSS and Cones at config 3's own size: volumes on the
    card, one run each, launch counts and recovery."""
    from dosma_tpu_torch.ops import monoexp_pipeline, registration

    shape = SCAN_SMALL_SHAPE
    affine = dt.to_affine(dt.SAGITTAL, SCAN_SPACING)
    out = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_scans_")
    try:
        # MAPSS: 7 echoes, echoes 1-6 rolled; intraregister, T1ρ and T2.
        sigs, _box = relaxometry_volumes(shape, MAPSS_TIMES)
        vols = [dt.MedicalVolume(torch.from_numpy(np.roll(v, MAPSS_SHIFT, axis=(0, 1, 2))
                                                  if i else v).to(dev), affine)
                for i, v in enumerate(sigs)]
        scan = dt.Mapss(vols, echo_times=list(MAPSS_TIMES))
        scan.temp_path = os.path.join(work, "mapss")
        check(scan.__validate_scan__(), "Mapss: 7 echoes expected")
        walls, launches = {}, {}
        with recorded_calls(registration, "warp_grid_batched") as warps:
            reset_launches()
            t0 = time.perf_counter()
            scan.intraregister()
            torch.cuda.synchronize()
            walls["intraregister_s"] = time.perf_counter() - t0
            launches["intraregister"] = expect_launches("Mapss.intraregister", warp_grid=1)
        err_w, _eq, *_ = check_recorded_warp("warp_grid Mapss intraregister", warps[0])
        del warps
        errs = [corner_error_vox(transform_matrix(os.path.join(
            scan.temp_path, "intraregistered", f"moving-{k}"))[0], affine, shape, MAPSS_SHIFT)
            for k in range(6)]
        check(max(errs) < RECOVERY_GATE, f"Mapss intraregister recovery {errs}")
        with recorded_calls(monoexp_pipeline, "monoexp_lm") as fits:
            for name, gen in (("t1rho", scan.generate_t1_rho_map), ("t2", scan.generate_t2_map)):
                reset_launches()
                t0 = time.perf_counter()
                qv = gen()
                torch.cuda.synchronize()
                walls[f"{name}_fit_s"] = time.perf_counter() - t0
                launches[name] = expect_launches(f"Mapss {name}", monoexp_lm=1)
                check(qv.volumetric_map.A.is_cuda and bool(torch.isfinite(qv.volumetric_map.A)
                                                           .all()), f"Mapss {name} map")
        fit_err = max(max(check_recorded_fit(f"monoexp_lm Mapss {i}", c)[:2])
                      for i, c in enumerate(fits))
        del fits
        print(f"phase 12 MAPSS on {card}, {shape} x 7 echoes on the card: intraregister "
              f"{walls['intraregister_s']:.4f} s (launches {launches['intraregister']}, "
              f"recovery {[round(e, 4) for e in errs]} voxel, warp kernel vs plain max|Δ| "
              f"{err_w:.3g}); T1ρ fit {walls['t1rho_fit_s'] * 1e3:.3f} ms, T2 fit "
              f"{walls['t2_fit_s'] * 1e3:.3f} ms (one monoexp_lm launch each, kernel vs "
              f"plain max|Δ| {fit_err:.3g})")
        out["mapss"] = {"shape": list(shape), "launches": launches, **walls,
                        "recovery_vox": errs, "max_abs_err": max(err_w, fit_err)}
        del scan, vols, sigs

        # Cones: 4 echoes; interregister to the last echo rolled, unmasked.
        sigs, _box = relaxometry_volumes(shape, CONES_TIMES)
        target_path = os.path.join(work, "cones_target.nii.gz")
        dt.MedicalVolume(np.roll(sigs[-1], CONES_TARGET_SHIFT, axis=(0, 1, 2)),
                         affine).save_volume(target_path)
        vols = [dt.MedicalVolume(torch.from_numpy(v).to(dev), affine) for v in sigs]
        scan = dt.Cones(vols, echo_times=list(CONES_TIMES))
        scan.temp_path = os.path.join(work, "cones")
        walls, launches = {}, {}
        with recorded_calls(registration, "warp_grid_batched") as warps:
            reset_launches()
            t0 = time.perf_counter()
            scan.interregister(target_path)
            torch.cuda.synchronize()
            walls["interregister_s"] = time.perf_counter() - t0
            launches["interregister"] = expect_launches("Cones.interregister", warp_grid=1)
        err_w, _eq, *_ = check_recorded_warp("warp_grid Cones interregister", warps[0])
        del warps
        err = corner_error_vox(transform_matrix(os.path.join(
            scan.temp_path, "interregistered", "moving-0"))[0], affine, shape,
            tuple(-s for s in CONES_TARGET_SHIFT))
        check(err < RECOVERY_GATE, f"Cones interregister recovery {err}")
        with recorded_calls(monoexp_pipeline, "monoexp_lm") as fits:
            reset_launches()
            t0 = time.perf_counter()
            qv = scan.generate_t2_star_map()
            torch.cuda.synchronize()
            walls["t2star_fit_s"] = time.perf_counter() - t0
            launches["t2star"] = expect_launches("Cones T2*", monoexp_lm=1)
        check(qv.volumetric_map.A.is_cuda and bool(torch.isfinite(qv.volumetric_map.A).all()),
              "Cones T2* map")
        fit_err = max(check_recorded_fit("monoexp_lm Cones", fits[0])[:2])
        del fits
        print(f"phase 12 Cones on {card}, {shape} x 4 echoes on the card: interregister "
              f"{walls['interregister_s']:.4f} s (launches {launches['interregister']}, "
              f"recovery {err:.4f} voxel, warp kernel vs plain max|Δ| {err_w:.3g}); T2* fit "
              f"{walls['t2star_fit_s'] * 1e3:.3f} ms (kernel vs plain max|Δ| {fit_err:.3g})")
        out["cones"] = {"shape": list(shape), "launches": launches, **walls,
                        "recovery_vox": err, "max_abs_err": max(err_w, fit_err)}
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_registered_scans(dt, dev, card):
    """Phase 12: CubeQuant at the knee's size, then MAPSS and Cones."""
    out = {"cubequant": phase_cubequant(dt, dev, card)}
    torch.cuda.empty_cache()
    out.update(phase_mapss_cones(dt, dev, card))
    return out


# ----------------------------------------------------------------------
# Phase 13: B-spline registration
# ----------------------------------------------------------------------
BSPLINE_AFFINE = np.diag([0.5, 0.6, 2.0, 1.0])  # bench.py:769


def bspline_pair(shape=REG_SHAPE):
    """bench.py:743-766: smooth blobs (a sigma-6 Gaussian of U(0, 1) from
    RandomState(7), scaled to 0..1000) and their warp by a +-2-voxel
    sinusoidal field; returns (fixed, moving, the field's function)."""
    from scipy import ndimage

    rs = np.random.RandomState(7)
    fixed = ndimage.gaussian_filter(rs.rand(*shape).astype(np.float32), 6.0)
    fixed = (fixed - fixed.min()) / (fixed.max() - fixed.min()) * 1000.0
    i, j, k = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")

    def field(y0, y1, y2):
        d0 = 2.0 * np.sin(2 * np.pi * y1 / shape[1]) * np.cos(2 * np.pi * y2 / (2 * shape[2]))
        d1 = -2.0 * np.cos(2 * np.pi * y0 / shape[0]) * np.sin(2 * np.pi * y2 / (2 * shape[2]))
        return d0, d1

    d0, d1 = field(i, j, k)
    moving = ndimage.map_coordinates(fixed, [i + d0, j + d1, k], order=1,
                                     mode="constant").astype(np.float32)
    return fixed, moving, field


def phase_bspline(dt, dev, card):
    """Phase 13: register(..., "bspline") on bench.py's recipe, held to its
    gates; apply_warp of a rigid + B-spline chain at a knee's size."""
    from dosma_tpu_torch.core.registration import _load_stage_params, _save_transform_file
    from dosma_tpu_torch.ops.bspline import bspline_displacement, make_control_grid
    from dosma_tpu_torch.ops.registration import _gauss_smooth3

    shape = REG_SHAPE
    fixed, moving, field = bspline_pair(shape)
    A = BSPLINE_AFFINE
    fv, mv = dt.MedicalVolume(fixed, A), dt.MedicalVolume(moving, A)
    cfg = _load_stage_params("bspline")
    work = tempfile.mkdtemp(prefix="chip_smoke_bspline_")
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dt.register(fv, mv, "bspline", output_path=work, return_volumes=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = expect_launches("register(bspline)")  # the point samplers: no warp_grid
        warped = out["volumes"][0].A
        check(isinstance(warped, np.ndarray) and warped.shape == shape
              and np.isfinite(warped).all(), "register(bspline): warped volume")
        c = tuple(slice(s // 8, -(s // 8)) for s in shape)
        res_before = float(np.sqrt(np.mean((moving[c] - fixed[c]) ** 2)))
        res_after = float(np.sqrt(np.mean((warped[c] - fixed[c]) ** 2)))
        # The displacement against the exact inverse of the known warp
        # (fixed-point solve of y + d(y) = x) on bench.py's interior grid.
        s0, s1, s2 = shape
        ii, jj, kk = np.mgrid[s0 // 8: 7 * s0 // 8: 6, s1 // 8: 7 * s1 // 8: 6,
                              s2 // 8: 7 * s2 // 8: 3].astype(np.float32)
        pts = np.stack([ii.ravel(), jj.ravel(), kk.ravel()])
        y = pts.copy()
        for _ in range(50):
            d0, d1 = field(y[0], y[1], y[2])
            y = pts - np.stack([d0, d1, np.zeros_like(d0)])
        u_true = y - pts
        tdata = json.load(open(out["outputs"][0].transform[0]))
        disp_mm = bspline_displacement(
            torch.tensor(tdata["ctrl"], dtype=torch.float32, device=dev),
            torch.from_numpy(pts).to(dev),
            torch.tensor(tdata["spacing_vox"], dtype=torch.float32, device=dev)).cpu().numpy()
        err_vox = np.linalg.norm(np.linalg.inv(A)[:3, :3] @ disp_mm - u_true, axis=0)
        mean_err, p95_err = float(err_vox.mean()), float(np.percentile(err_vox, 95))
        print(f"phase 13: register(bspline) on bench.py's recipe ({shape}, {A[0, 0]}x{A[1, 1]}"
              f"x{A[2, 2]} mm, RandomState(7)): residual RMSE {res_before:.4f} -> "
              f"{res_after:.4f} ({res_after / res_before:.4f} of it; gate 0.1); displacement "
              f"error against the exact inverse: mean {mean_err:.4f}, p95 {p95_err:.4f} voxel "
              f"(gate: mean 0.3); warp_grid launches {launches['warp_grid']} (the mixed "
              f"chain samples points, as in dosma_tpu)")
        check(res_after < 0.1 * res_before, f"bspline residual {res_after} vs {res_before}")
        check(mean_err < 0.3, f"bspline displacement error {mean_err} voxel")

        def timed():
            dt.register(fv, mv, "bspline", output_path=work, save_volumes=False)

        with utilization_sampler() as util:
            wall_s, walls = median_wall(timed, reps=1)
        iters = sum(cfg.level_budget(cfg.resolutions)[0])
        print(f"phase 13 on {card}: register(bspline) first call {first_s:.4f} s; warm "
              f"(save_volumes=False), one run: {wall_s:.4f} s; {iters} Adam iterations, "
              f"{wall_s * 1e3 / iters:.4f} ms each; the card busy {util.busy:.4f} (idle "
              f"{1 - util.busy:.4f}; nvidia-smi, {util.samples} samples)")
        result = {"shape": list(shape), "first_s": first_s, "wall_s": wall_s, "walls": walls,
                  "ms_per_iteration": wall_s * 1e3 / iters, "idle_share": 1 - util.busy,
                  "residual_before": res_before, "residual_after": res_after,
                  "mean_disp_err_vox": mean_err, "p95_disp_err_vox": p95_err,
                  "warp_grid_launches": launches["warp_grid"]}

        # A rigid + B-spline transform-file chain on four knee volumes.
        kshape, kA = KNEE_SHAPE, WARP_AFFINE
        cw = (kA @ np.r_[(np.asarray(kshape) - 1) / 2.0, 1.0])[:3]
        a = np.deg2rad(3.0)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = cw - R @ cw + np.array([1.0, -1.0, 0.5])
        grid_shape, spacing = make_control_grid(kshape, kA, 32.0)
        ctrl = np.random.RandomState(8).uniform(-2.0, 2.0, (3, *grid_shape)).astype(np.float32)
        knee_mv = dt.MedicalVolume(np.zeros(kshape, np.float32), kA)
        files = [os.path.join(work, "knee", f"TransformParameters.{i}.json") for i in (0, 1)]
        _save_transform_file(files[0], ("matrix", M), _load_stage_params("rigid"), knee_mv,
                             knee_mv)
        _save_transform_file(files[1], ("bspline", ctrl, spacing), cfg, knee_mv, knee_mv)
        # Smooth volumes, as images are: bench.py's blob recipe (a sigma-6
        # Gaussian of U(0, 1), scaled to 0..1000) made on the card. On white
        # noise x 1000, float32 coordinates that differ by ~1e-5 voxel
        # between the card's and the CPU's products move a sample by up to
        # 0.06 (3,766 voxels beyond the tolerance in this script's first run).
        gen = torch.Generator(device=dev).manual_seed(3)
        vols = []
        for _ in range(KNEE_VOLUMES):
            v = _gauss_smooth3(torch.rand(kshape, generator=gen, device=dev), 6.0, 18)
            vols.append(dt.MedicalVolume((v - v.min()) / (v.max() - v.min()) * 1000.0, kA))
            del v
        reset_launches()
        dt.apply_warp(vols, transform=files)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        warped4 = dt.apply_warp(vols, transform=files)
        end.record()
        end.synchronize()
        apply_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated()
        knee_launches = expect_launches("apply_warp(rigid + bspline)")
        check(len(warped4) == KNEE_VOLUMES and all(w.A.is_cuda and w.shape == kshape
                                                   for w in warped4), "apply_warp knee volumes")
        # The CPU's run of the same chain on a slab of the output: the first
        # KNEE_CPU_ROWS rows along axis 0, the same fixed-grid points (their
        # index coordinates do not depend on the grid's extent).
        from dosma_tpu_torch.core.registration import _load_transform_file, _stage_from_tdata
        from dosma_tpu_torch.ops.registration import warp_volume_chain

        tdata = [_load_transform_file(f) for f in files]
        slab = (KNEE_CPU_ROWS, *kshape[1:])
        t0 = time.perf_counter()
        with dt.default_device("cpu"):
            host = warp_volume_chain(vols[0].A.cpu().numpy(), [_stage_from_tdata(t) for t in tdata],
                                     np.asarray(tdata[0]["fixed_affine"]), kA, slab,
                                     order=int(tdata[-1].get("final_interp_order", 1)))
        cpu_s = time.perf_counter() - t0
        got = warped4[0].A[:KNEE_CPU_ROWS]
        want = torch.as_tensor(host).to(dev)
        diff = (got - want).abs()
        outside = int((diff > 1e-4 * torch.clamp(want.abs(), min=1.0)).sum())
        knee_err = float(diff.max())
        print(f"phase 13 knee: apply_warp of {KNEE_VOLUMES} x {kshape} f32 (smooth blobs, "
              f"0..1000) with a rigid (3 "
              f"degrees, (1, -1, 0.5) mm) + B-spline (grid {grid_shape}, U(-2, 2) mm, "
              f"RandomState(8)) transform-file chain, order {cfg.final_interp_order}: "
              f"{apply_ms:.3f} ms (CUDA events around the call), peak memory "
              f"{peak / 2**30:.3f} GiB, launches {knee_launches}; volume 0's first "
              f"{KNEE_CPU_ROWS} rows against the port's CPU run of the same chain on that slab "
              f"({cpu_s:.2f} s): max|Δ| {knee_err:.3g}, {outside} voxels beyond "
              f"1e-4 * max(1, |v|)")
        check(outside == 0, f"knee apply_warp: {outside} voxels differ from the CPU run")
        result.update({"knee_apply_warp_ms": apply_ms, "knee_peak_bytes": peak,
                       "knee_max_abs_err": knee_err, "knee_cpu_s": cpu_s,
                       "knee_grid_shape": list(grid_shape)})
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 14: several cards and U-Net training (one rank a card, NCCL)
# ----------------------------------------------------------------------
TRAIN_BATCH = 8
TRAIN_STEPS = 5
TRAIN_SAVE_STEP = 3
# Adam's first steps move every leaf by about lr: at full width 1e-3 (the
# trainer's default) drives the sigmoid head into saturation by step 2
# (tools/rehearse_train_cpu.py at 96x96: 1.3157 -> 1.8979 and flat), 1e-4
# falls steadily.
TRAIN_LR = 1e-4
TRAIN_SLICES = slice(76, 76 + TRAIN_BATCH)  # the knee's middle slices
TRAIN_GRAD_RTOL = 1e-4  # per leaf |Δg|/|g| against float64 (or float32's own error there)
SHARDED_SLICES = KNEE_SHAPE[2]
SHARDED_REG_SHIFTS = (REG_SHIFT, (-3, 2, -1))
SHARDED_REG_CFG = dict(transform="affine", metric="mse", resolutions=2, iterations=100,
                       num_samples=4096, learning_rate=0.05)
SHARDED_INFER_TOL = 1e-5


def offset_exp_user(x_col, params):
    """Phase 6's model in lm_fit's form (``model(x_col, params)``), as a
    user hands it to ``sharded_lm_fit``."""
    return offset_exp(x_col, *params)


def sharded_programs():
    """The generic kernels' programs of phase 14 (the sharded fit's user
    model and the dry run's), built in phase 2 with the others."""
    from dosma_tpu_torch.ops.generic_lm import compile_model
    from dosma_tpu_torch.parallel import dryrun
    from dosma_tpu_torch.parallel.sharding import _with_arity

    return {"P3_offset_user": compile_model(_with_arity(offset_exp_user, 3), 3),
            "P2_dryrun_mono": compile_model(_with_arity(dryrun._mono, 2), 2)}


def knee_training_batch():
    """Phase 10's knee (RandomState(4) x 1000), whitened, and the condyle
    arc's labels: (images, labels) NHWC (TRAIN_BATCH, 384, 384, 1)."""
    knee = np.random.RandomState(4).rand(*KNEE_SHAPE).astype(np.float32) * 1000
    x = np.ascontiguousarray(knee[:, :, TRAIN_SLICES].transpose(2, 0, 1)[..., None])
    x = (x - x.mean()) / x.std()
    arc = condyle_arc(KNEE_SHAPE)[:, :, TRAIN_SLICES].transpose(2, 0, 1)[..., None]
    return x.astype(np.float32), np.ascontiguousarray(arc, dtype=np.float32)


def phase_parallel_train(dt, dev, card):
    """Phase 14 (see the module docstring)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from dosma_tpu_torch.models.unet2d import FEATURES, UNet2D, Unet2D, cudnn_exact
    from dosma_tpu_torch.models.weights import params_from_state_dict, state_dict_from_params
    from dosma_tpu_torch.ops.biexp import biexp_lm
    from dosma_tpu_torch.ops.generic_lm import generic_lm
    from dosma_tpu_torch.ops.monoexp import monoexp_lm
    from dosma_tpu_torch.ops.registration import RegistrationParams, register_chain_batch
    from dosma_tpu_torch.parallel import sharding as S
    from dosma_tpu_torch.train import SegTrainer
    from dosma_tpu_torch.train.seg_trainer import dice_bce_loss, unet_train_forward

    result = {}
    # 14a. The dry run module at one rank a card, NCCL, in its own processes.
    n_cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dosma_tpu_torch.parallel.dryrun", "--ranks", str(n_cards),
         "--backend", "nccl", "--timeout", "300"],
        capture_output=True, text=True, timeout=400,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    dry_s = time.perf_counter() - t0
    line = (proc.stdout.strip().splitlines() or [""])[-1]
    check(proc.returncode == 0 and line.startswith("dryrun_multichip OK"),
          f"the dry run failed (exit {proc.returncode}): {line}\n{proc.stderr[-4000:]}")
    print(f"phase 14 dry run: python -m dosma_tpu_torch.parallel.dryrun --ranks {n_cards} "
          f"--backend nccl: {line} ({dry_s:.1f} s)")
    result["dryrun"] = {"ranks": n_cards, "line": line, "seconds": dry_s}

    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(work, 'rendezvous')}",
                            rank=0, world_size=1)
    try:
        mesh = S.get_mesh()
        check(mesh.device_mesh is not None and mesh.device == dev, f"mesh {mesh} on {dev}")

        # 14b. Full-width training at batch 8, a checkpoint and its resume.
        images, labels = knee_training_batch()
        params = he_normal_unet_params(np.random.RandomState(0), 1, FEATURES)
        trainer = SegTrainer(params=params, learning_rate=TRAIN_LR)
        check(trainer.mesh.shape == (1, 1) and trainer.mesh.device_mesh is not None,
              f"the trainer's mesh {trainer.mesh}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for step in range(1, TRAIN_STEPS + 1):
            if step == TRAIN_SAVE_STEP + 1:
                t0 = time.perf_counter()
                trainer.save(work, TRAIN_SAVE_STEP)
                save_s = time.perf_counter() - t0
                resumed = SegTrainer(params=params, learning_rate=TRAIN_LR)
                t0 = time.perf_counter()
                resumed.restore(work)
                restore_s = time.perf_counter() - t0
            start.record()
            losses.append(trainer.step(images, labels))
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            if step == TRAIN_SAVE_STEP + 1:
                resumed_loss = resumed.step(images, labels)
                same_params = all(torch.equal(resumed.params[k], p)
                                  for k, p in trainer.params.items())
                check(resumed_loss == losses[-1] and same_params,
                      f"the resumed trainer's step {step}: loss {resumed_loss} vs {losses[-1]}, "
                      f"parameters equal: {same_params}")
                del resumed
        peak = torch.cuda.max_memory_allocated()
        check(np.isfinite(losses).all() and losses[-1] < losses[0], f"losses {losses}")
        warm_ms = statistics.median(step_ms[1:])
        flops = 3 * unet_flops(KNEE_SHAPE[0], KNEE_SHAPE[1], FEATURES, 1) * TRAIN_BATCH
        bound_ms = flops / PEAK_F32_PER_S * 1e3
        n_params = sum(p.numel() for p in trainer.params.values())
        print(f"phase 14 training on {card}: SegTrainer(FEATURES, num_classes=1, "
              f"learning_rate={TRAIN_LR}) at full width "
              f"({n_params:,} parameters, every leaf trained), {TRAIN_BATCH} knee slices of "
              f"{KNEE_SHAPE[0]}x{KNEE_SHAPE[1]} (phase 10's knee, whitened; the condyle arc's "
              f"labels), {TRAIN_STEPS} steps on one batch: losses "
              f"{[round(v, 6) for v in losses]}; step ms (CUDA events) "
              f"{[round(v, 3) for v in step_ms]}, warm median {warm_ms:.3f} ms against a bound "
              f"of {bound_ms:.3f} ms (3 x the forward's {flops / 3 / 1e12:.4f} TFLOP at 67 "
              f"TFLOP/s; {bound_ms / warm_ms:.4f} of it); peak memory {peak / 2**30:.3f} GiB")
        print(f"phase 14 checkpoint: save at step {TRAIN_SAVE_STEP} {save_s:.3f} s, restore "
              f"into a fresh trainer {restore_s:.3f} s; step {TRAIN_SAVE_STEP + 1} in both: "
              f"the losses and every parameter bit-equal")
        del trainer
        torch.cuda.empty_cache()

        # One slice's gradients on the card against float64 on the CPU, leaf by
        # leaf; float32 on the CPU beside them, since the bottleneck's leaves
        # sum thousands of terms of either sign and float32 itself misses
        # 1e-4 there (tools/train_grad_accuracy.py: 7.18e-4 on the CPU,
        # 2.47e-4 under cudnn_exact): a leaf is held to the larger of 1e-4
        # and the CPU's float32 error on it.
        t0 = time.perf_counter()
        _loss, g_card = SegTrainer(params=params).loss_and_grads(images[:1], labels[:1])
        state = dict(state_dict_from_params(params))
        x1 = torch.from_numpy(images[:1]).permute(0, 3, 1, 2)
        y1 = torch.from_numpy(labels[:1]).permute(0, 3, 1, 2)

        def cpu_grads(dtype):
            p = {k: v.to(dtype).requires_grad_(True) for k, v in state.items()}
            dice_bce_loss(unet_train_forward(p, x1.to(dtype)), y1.to(dtype)).backward()
            return params_from_state_dict({k: v.grad for k, v in p.items()})

        g64, g32 = cpu_grads(torch.float64), cpu_grads(torch.float32)
        leaves = []
        for (path, a), (_p, b), (_q, c) in zip(leaf_items(g_card), leaf_items(g64),
                                                leaf_items(g32), strict=True):
            norm = max(np.linalg.norm(b), 1e-300)
            leaves.append((float(np.linalg.norm(a.astype(np.float64) - b) / norm),
                           float(np.linalg.norm(c.astype(np.float64) - b) / norm), path))
        worst, worst_cpu, worst_leaf = max(leaves)
        beyond = [(e, c, p) for e, c, p in leaves if e > max(TRAIN_GRAD_RTOL, c)]
        past_f32 = sum(c > TRAIN_GRAD_RTOL for _e, c, _p in leaves)
        grad_s = time.perf_counter() - t0
        print(f"phase 14 gradients of slice {TRAIN_SLICES.start} on the card (float32, "
              f"cudnn_exact) against float64 on the CPU, per leaf |Δg|/|g|: worst {worst:.4g} "
              f"at {worst_leaf}, where float32 on the CPU is {worst_cpu:.4g}; {past_f32} of "
              f"{len(leaves)} leaves have a CPU float32 error above {TRAIN_GRAD_RTOL}; bound "
              f"per leaf max({TRAIN_GRAD_RTOL}, the CPU's float32 error) ({grad_s:.1f} s)")
        check(not beyond, f"gradients beyond their bound: {beyond[:4]}")
        del g64, g32, g_card
        result["training"] = {
            "batch": TRAIN_BATCH, "shape": [KNEE_SHAPE[0], KNEE_SHAPE[1]], "losses": losses,
            "step_ms": step_ms, "warm_step_ms": warm_ms, "bound_ms": bound_ms,
            "bound_share": bound_ms / warm_ms, "peak_bytes": peak, "parameters": n_params,
            "grad_worst_rel": worst, "grad_worst_leaf": worst_leaf,
            "grad_worst_leaf_cpu_f32_rel": worst_cpu, "leaves_past_1e-4_in_f32": past_f32,
            "save_s": save_s, "restore_s": restore_s}

        # 14c. Sharded fits on phases 4-6's data: one launch each, rows
        # bit-equal to the unsharded kernel's on the same voxels.
        fits = {}
        mono_y = config1_data()[0]
        cases = {
            "monoexp_lm": (dt.monoexponential, ECHO_TIMES, mono_y, np.array([1.0, -1 / 30]),
                           {"max_iter": 50}, lambda y, p0, kw: monoexp_lm(ECHO_TIMES, y, p0, **kw)),
            "biexp_lm": (dt.biexponential, BIEXP_X, biexp_data(), np.array(BIEXP_P0),
                         {"max_iter": 100}, lambda y, p0, kw: biexp_lm(BIEXP_X, y, p0, **kw)),
            "generic_lm": (offset_exp_user, GENERIC_X, generic_data()[0], np.array(GENERIC_P0),
                           {"max_iter": 60},
                           lambda y, p0, kw: generic_lm(offset_exp, GENERIC_X, y, p0, **kw)),
        }
        for name, (model, x, Y, p0, kw, unsharded) in cases.items():
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            popt, r2, conv = S.sharded_lm_fit(model, x, Y, p0.astype(np.float32), **kw)
            wall_s = time.perf_counter() - t0
            counts = expect_launches(f"sharded_lm_fit ({name})", **{name: 1})
            ref = unsharded(torch.from_numpy(Y).to(dev), p0.astype(np.float32), kw)
            equal = all(np.array_equal(a, b.cpu().numpy(), equal_nan=True)
                        for a, b in zip((popt, r2, conv), ref))
            check(equal, f"sharded_lm_fit ({name}): rows differ from the unsharded kernel's")
            fits[name] = {"voxels": int(Y.shape[0]), "launches": counts[name], "wall_s": wall_s,
                          "converged": float(conv.mean())}
            print(f"phase 14 sharded_lm_fit ({name}): {Y.shape[0]} voxels x {Y.shape[1]} on "
                  f"{mesh}, launches {counts}, wall {wall_s:.4f} s (host in, host out), "
                  f"converged {conv.mean():.4f}; rows bit-equal to the unsharded kernel's")
        result["fits"] = fits

        # profiling.trace around one warm sharded fit shows the kernel (in a
        # fresh process: one with many profiler sessions behind it misses
        # events, as phase 11 found for memcpys).
        trace = trace_in_fresh_process(os.path.join(work, "trace"))
        kernels = [k for k in trace["events"] if "monoexp_lm" in k[0] and k[2] == "kernel"]
        check(len(kernels) == 1 and trace["annotated"],
              f"the trace holds {len(kernels)} monoexp_lm kernels: {trace['events'][:8]}")
        print(f"phase 14 profiling.trace (a fresh process, world 1): "
              f"{trace['bytes']:,} bytes, {kernels[0][0][:48]} {kernels[0][1]} us inside the "
              f"'sharded_lm_fit' annotation")
        result["trace_kernel_us"] = kernels[0][1]

        # 14d. Sharded registration: phase 7's phantom, two rolled volumes.
        fixed = registration_phantom()[0]
        movings = np.stack([np.roll(fixed, s, axis=(0, 1, 2)) for s in SHARDED_REG_SHIFTS])
        cfgs = [RegistrationParams(**SHARDED_REG_CFG)]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        Ms, warped = S.sharded_register_chain_batch(fixed, REG_AFFINE, movings, REG_AFFINE, cfgs)
        reg_s = time.perf_counter() - t0
        reg_counts = expect_launches("sharded_register_chain_batch", warp_grid=1)
        Ms_ref, warped_ref, _ = register_chain_batch(fixed, REG_AFFINE, movings, REG_AFFINE, cfgs)
        check(np.array_equal(Ms, Ms_ref) and np.array_equal(warped, warped_ref),
              "sharded_register_chain_batch differs from register_chain_batch")
        errs = [corner_error_vox(Ms[i, -1], shift=s) for i, s in enumerate(SHARDED_REG_SHIFTS)]
        print(f"phase 14 sharded_register_chain_batch: {len(movings)} moving {REG_SHAPE} volumes "
              f"({SHARDED_REG_CFG}), {reg_s:.3f} s, launches {reg_counts}; Ms and the warped "
              f"stack equal to register_chain_batch's; corner errors {[round(e, 4) for e in errs]}"
              f" voxel")
        result["registration"] = {"launches": reg_counts["warp_grid"], "seconds": reg_s,
                                  "corner_err_vox": errs}

        # 14e. Sharded inference at full width on 160 slices.
        knee = np.random.RandomState(4).rand(*KNEE_SHAPE).astype(np.float32) * 1000
        v = np.ascontiguousarray(knee.transpose(2, 0, 1)[..., None])
        v = (v - v.mean()) / v.std()
        del knee
        seg = Unet2D((KNEE_SHAPE[0], KNEE_SHAPE[1], 1), num_classes=4)
        seg.params = he_normal_unet_params(np.random.RandomState(0), 4, FEATURES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = S.sharded_unet_inference(seg, v)
        infer_s = time.perf_counter() - t0
        net = UNet2D.from_params(seg.params).to(dev).eval()
        x = torch.from_numpy(v).to(dev).permute(0, 3, 1, 2)
        with torch.inference_mode(), cudnn_exact():
            want = torch.cat([net(x[s:s + 16]) for s in range(0, SHARDED_SLICES, 16)])
            want = want.permute(0, 2, 3, 1).cpu().numpy()
        infer_err = float(np.abs(probs - want).max())
        check(probs.shape == want.shape and infer_err <= SHARDED_INFER_TOL,
              f"sharded_unet_inference: max|Δp| {infer_err}")
        print(f"phase 14 sharded_unet_inference: {SHARDED_SLICES} slices of "
              f"{KNEE_SHAPE[0]}x{KNEE_SHAPE[1]}, full width, 4 classes, {infer_s:.3f} s (host "
              f"in, host out); max|Δp| against UNet2D's forward {infer_err:.3g} (bound "
              f"{SHARDED_INFER_TOL})")
        result["inference"] = {"slices": SHARDED_SLICES, "seconds": infer_s,
                               "max_abs_err": infer_err}
        del net, x, v, probs, want
        torch.cuda.empty_cache()

        # 14f. The sharded qDESS flow on phase 11's echoes.
        pixels, headers, affine = qdess_knee_series()
        series_dir = os.path.join(work, "qdess")
        dt.DicomWriter(num_workers=8).save(dt.MedicalVolume(pixels, affine, headers=headers),
                                           series_dir)
        sharding = S.NamedSharding(mesh, S.PartitionSpec(None, None, "data"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        echoes = dt.load_to_device(series_dir, sharding=sharding, num_workers=8)
        t2 = dt.QDess(echoes).generate_t2_map(t1=1200.0)
        torch.cuda.synchronize()
        qdess_s = time.perf_counter() - t0
        vol = t2.volumetric_map.volume
        check(isinstance(vol, DTensor) and [type(p).__name__ for p in vol.placements]
              == ["Shard"], f"the T2 map is {type(vol).__name__}, not a sharded DTensor")
        scan = dt.QDess.from_dicom(series_dir, to_device=True, num_workers=8)
        ref = scan.generate_t2_map(t1=1200.0).volumetric_map
        check(torch.equal(vol.full_tensor(), ref.volume), "the sharded T2 map differs")
        arc = dt.MedicalVolume(condyle_arc(KNEE_SHAPE), affine)

        def fc_rows(qmap):
            fc = dt.FemoralCartilage()
            fc.set_mask(arc, use_largest_cc=False, split_regions=True)
            return fc.quant_rows(qmap, t2.qv_type)

        t0 = time.perf_counter()
        rows = fc_rows(t2.volumetric_map)
        rows_s = time.perf_counter() - t0
        rel = check_tissue_rows("fc (sharded T2)", rows, fc_rows(ref))
        print(f"phase 14 sharded qDESS: load_to_device(sharding=Shard(2)) of {2 * KNEE_SHAPE[2]} "
              f"files -> QDess.generate_t2_map: {qdess_s:.3f} s, a DTensor bit-equal to the "
              f"unsharded card map; fc's {len(rows[1])} rows (the map gathered whole first, "
              f"{int(np.prod(KNEE_SHAPE)) * 4:,} bytes) in {rows_s:.3f} s, within "
              f"{rel:.3g} of the unsharded map's (rtol {QDESS_RTOL})")
        result["qdess"] = {"seconds": qdess_s, "rows": len(rows[1]), "rows_s": rows_s,
                           "rows_max_rel": rel}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    return result


TRACE_CODE = """
import json, os, sys
import numpy as np, torch
import chip_smoke as C
import dosma_tpu_torch as dt
from dosma_tpu_torch.parallel.sharding import sharded_lm_fit
from dosma_tpu_torch.utils import profiling

y, p0 = C.config1_data()[0], np.array([1.0, -1 / 30], np.float32)
sharded_lm_fit(dt.monoexponential, C.ECHO_TIMES, y, p0)
torch.cuda.synchronize()
with profiling.trace(sys.argv[1]) as prof:
    with profiling.annotate("sharded_lm_fit"):
        sharded_lm_fit(dt.monoexponential, C.ECHO_TIMES, y, p0)
    torch.cuda.synchronize()
events = json.load(open(prof.trace_path))["traceEvents"]
print(json.dumps({"bytes": os.path.getsize(prof.trace_path),
                  "annotated": any(e.get("name") == "sharded_lm_fit" for e in events),
                  "events": [[e["name"], e.get("dur"), e.get("cat")] for e in events
                             if e.get("cat") in ("kernel", "gpu_memcpy")
                             or "monoexp" in str(e.get("name"))]}))
"""


def trace_in_fresh_process(log_dir):
    """``profiling.trace`` around a warm ``sharded_lm_fit`` at config1 in a
    new process: its trace's size, whether the annotation is in it, and its
    kernel, copy and monoexp events (name, us, category)."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", TRACE_CODE, log_dir], capture_output=True,
                          text=True, timeout=300, cwd=root)
    check(proc.returncode == 0, f"the traced fit failed: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def leaf_items(tree, path=""):
    """(path, leaf) pairs of a nested dict / list of arrays."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_items(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_items(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(tree)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="stop after phase 3 (build and small cases); phases 4-11 (the "
                             "full-width paths, phase 9 the DICOM series, phase 10 "
                             "segmentation, phase 11 the qDESS knee) do not run; prints "
                             "no result")
    parser.add_argument("--qdess-only", action="store_true",
                        help="run phase 11 alone after phase 1 (no kernel is built or "
                             "checked); prints no result")
    parser.add_argument("--scans-only", action="store_true",
                        help="run phases 1, 2, 12 and 13 (the registered scans and the "
                             "B-spline stage); prints their objects and no result")
    parser.add_argument("--train-only", action="store_true",
                        help="run phases 1, 2 and 14 (the sharded entry points and U-Net "
                             "training); prints its object and no result")
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

    if opts.qdess_only:
        t_start = time.perf_counter()
        print(json.dumps({"qdess_knee": phase_qdess_knee(dt, dev, card)}))
        print(f"phase 11 alone: {time.perf_counter() - t_start:.1f} s")
        return 0

    build_all()  # phase 2
    if opts.train_only:
        t_start = time.perf_counter()
        parallel = phase_parallel_train(dt, dev, card)
        print(f"phase 14: {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"parallel_train": parallel}))
        return 0
    if opts.scans_only:
        t_start = time.perf_counter()
        scans = phase_registered_scans(dt, dev, card)
        print(f"phase 12: {time.perf_counter() - t_start:.1f} s")
        t_start = time.perf_counter()
        bspline = phase_bspline(dt, dev, card)
        print(f"phase 13: {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"registered_scans": scans}))
        print(json.dumps({"bspline": bspline}))
        return 0
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
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    phase_dicom(dt, dev, card)
    print(f"phase 9: {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    seg, seg_model = phase_segmentation(dt, dev, card)
    print(f"phase 10: {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    qdess_knee = phase_qdess_knee(dt, dev, card, model=seg_model)
    print(f"phase 11: {time.perf_counter() - t_start:.1f} s")
    del seg_model
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    scans = phase_registered_scans(dt, dev, card)
    print(f"phase 12: {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    bspline = phase_bspline(dt, dev, card)
    print(f"phase 13: {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    parallel = phase_parallel_train(dt, dev, card)
    print(f"phase 14: {time.perf_counter() - t_start:.1f} s")
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
            "bench_192x192x48_order1_kernel_ms": knee["bench_kernel_ms"],
            **{k: v for k, v in reg.items() if k not in ("launches", "max_abs_err")}}
    warp["max_abs_err"] = max(warp["max_abs_err"], reg["max_abs_err"])
    # Phase 12's paths: their launches, and the kernel at the CubeQuant's shapes.
    cq = scans["cubequant"]
    warp["scan_launches"] = {
        "cubequant": {k: cq["launches"][k]["warp_grid"] for k in ("intraregister", "interregister")},
        "mapss_intraregister": scans["mapss"]["launches"]["intraregister"]["warp_grid"],
        "cones_interregister": scans["cones"]["launches"]["interregister"]["warp_grid"]}
    warp["cubequant_warps"] = cq["warps"]
    warp["max_abs_err"] = max(warp["max_abs_err"],
                              *(w["max_abs_err"] for w in cq["warps"].values()))
    mono["scan_launches"] = {
        "cubequant_t1rho": cq["launches"]["fit"]["monoexp_lm"],
        **{f"mapss_{k}": scans["mapss"]["launches"][k]["monoexp_lm"] for k in ("t1rho", "t2")},
        "cones_t2star": scans["cones"]["launches"]["t2star"]["monoexp_lm"]}
    mono["max_abs_err"] = max(mono["max_abs_err"], cq["fit_max_abs_err"],
                              scans["mapss"]["max_abs_err"], scans["cones"]["max_abs_err"])
    # Phase 14's sharded paths: one launch a rank each.
    for name, res in (("monoexp_lm", mono), ("biexp_lm", biexp), ("generic_lm", generic)):
        res["sharded_launches"] = {"sharded_lm_fit": parallel["fits"][name]["launches"]}
    warp["sharded_launches"] = {
        "sharded_register_chain_batch": parallel["registration"]["launches"]}

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
    print(json.dumps({"segmentation": seg}))
    print(json.dumps({"qdess_knee": qdess_knee}))
    print(json.dumps({"registered_scans": scans}))
    print(json.dumps({"bspline": bspline}))
    print(json.dumps({"parallel_train": parallel}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
