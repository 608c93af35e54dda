#!/usr/bin/env python3
"""Where the time of the port's matrix registration goes on a CUDA card.

Usage, from the repository root on a machine with one CUDA card:

    python3 tools/profile_registration.py [--reps 1] [--out FILE]

On the phantom of ``chip_smoke.py`` phase 7 (192x192x48, a bright box plus
noise, moving = fixed rolled by (4, -3, 1)), as host volumes through
``register(..., "affine")`` (3 levels x 250 iterations x 2,048 samples), it
measures:
  1. the warm wall of ``register`` with ``save_volumes=False`` and with
     ``save_volumes=True`` (the difference is the D2H copy and the gzip
     NIfTI write of the result), median of 3;
  2. the layers of one stage, each timed on its own (host wall, ending in
     ``torch.cuda.synchronize()``): the level set-up (smoothing of both
     images, the draws, the sort and the fixed-side sampling: the stage
     run with 0 iterations), the whole stage (``_pyramid_core``), hence the
     Adam loop and its host ms per iteration, and the final warp
     (prefilter + ``warp_grid``, order 3);
  3. ``torch.profiler`` over ``--reps`` warm ``register`` calls: device
     busy time per call, the device's idle share of the wall, and the
     kernels by CUDA self time.
Every section prints the card's name and power limit. With ``--out`` the
whole report is also written to FILE. It imports nothing of JAX.
"""

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _wall_s(fn, reps=3):
    """Median host wall (s) of ``fn`` ending in a synchronize, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=1, help="register calls under the profiler")
    ap.add_argument("--out", type=Path, default=None, help="also write the report here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_registration: a CUDA card is required", file=sys.stderr)
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
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products (the port's default)

    import dosma_tpu_torch as dt
    from chip_smoke import REG_AFFINE, REG_SHAPE, registration_phantom
    from dosma_tpu_torch.core.registration import _load_stage_params
    from dosma_tpu_torch.ops import registration as R
    from profile_monoexp_fit import _profile

    dev = torch.device("cuda", 0)
    fixed, moving = registration_phantom()
    fv, mv = dt.MedicalVolume(fixed, REG_AFFINE), dt.MedicalVolume(moving, REG_AFFINE)
    cfg = _load_stage_params("affine")
    say(f"register(affine) on {REG_SHAPE}: {cfg.resolutions} levels x {cfg.iterations} "
        f"iterations x {cfg.num_samples} samples, on {card}")
    out_dir = tempfile.mkdtemp(prefix="profile_registration_")

    # 1. The entry point, without and with the result file.
    for save in (False, True):
        wall, walls = _wall_s(lambda: dt.register(fv, mv, "affine", output_path=out_dir,
                                                  save_volumes=save))
        say(f"[register save_volumes={save}] warm wall median {wall:.4f} s "
            f"runs {[round(w, 4) for w in walls]}")

    # 2. The layers of the stage, each on its own.
    f_t = torch.from_numpy(fixed).to(dev)
    m_t = torch.from_numpy(moving).to(dev)
    A = torch.from_numpy(REG_AFFINE.astype(np.float32)).to(dev)
    center = R._fixed_center(REG_SHAPE, REG_AFFINE)
    scale = R._param_scale(cfg.transform, REG_SHAPE, R._spacing(REG_AFFINE))
    sigmas = R._stage_sigmas(cfg)

    def stage(iterations):
        return R._pyramid_core(
            f_t, A, None, m_t, A, torch.zeros(cfg.nparams, device=dev),
            torch.from_numpy(scale).to(dev), torch.from_numpy(center).to(dev), sigmas,
            cfg.transform, cfg.metric, iterations, cfg.num_samples, cfg.num_bins,
            cfg.learning_rate, cfg.seed, radius=R._smooth_radius_for_sigmas(sigmas),
            mi_kernel=cfg.mi_kernel, interp_order=cfg.interp_order)

    setup_s, _ = _wall_s(lambda: stage(0))
    stage_s, stage_all = _wall_s(lambda: stage(cfg.iterations))
    n_it = cfg.resolutions * cfg.iterations
    loop_s = stage_s - setup_s
    say(f"[stage] whole _pyramid_core {stage_s:.4f} s runs {[round(w, 4) for w in stage_all]}; "
        f"level set-up (smoothing, draws, sort, fixed sampling; 0 iterations) {setup_s:.4f} s; "
        f"Adam loop {loop_s:.4f} s = {loop_s / n_it * 1e3:.4f} ms per iteration "
        f"({n_it} iterations)")
    B = torch.eye(4, device=dev)
    warp_s, _ = _wall_s(lambda: R._warp_arr(m_t, B, REG_SHAPE, cfg.final_interp_order), reps=5)
    say(f"[final warp] prefilter + warp_grid, order {cfg.final_interp_order}: {warp_s * 1e3:.4f} ms")

    # 3. The profiler over warm register calls.
    _profile("register(affine), save_volumes=False",
             lambda: dt.register(fv, mv, "affine", output_path=out_dir, save_volumes=False),
             args.reps, say)

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
