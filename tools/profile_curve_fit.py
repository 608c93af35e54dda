#!/usr/bin/env python3
"""Where the time of the port's curve-fitting path goes on a CUDA card.

Usage, from the repository root on a machine with one CUDA card:

    python3 tools/profile_curve_fit.py [--reps 3] [--out FILE]

With the data of ``chip_smoke.py`` phases 5 and 6 on the card (512x512x16
voxels, seed 0), it measures:
  1. the first ``torch.func.jvp`` call of the process, which ``curve_fit``
     makes to decide whether a model is differentiable (it imports
     ``torch._dynamo``), then the first ``CurveFitter(biexponential).fit``;
  2. ``CurveFitter(biexponential).fit`` on eight echo volumes, warm: host
     wall per fit (median, no profiler), then ``torch.profiler`` over
     ``--reps`` fits: per-op CUDA self times, device busy time per fit and
     the device's idle share;
  3. ``curve_fit`` of ``a * exp(b x) + c`` on (5, N) data, warm: the same;
  4. the host cost per ``curve_fit`` call of its routing decisions:
     ``_as_torch_model`` (the ``torch.func.jvp`` probe) and
     ``compile_model`` (the ``torch.fx`` trace and whitelist check), median
     of 20 each.
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


def _host_ms(fn, reps=20):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3, help="calls under the profiler")
    ap.add_argument("--out", type=Path, default=None, help="also write the report here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_curve_fit: a CUDA card is required", file=sys.stderr)
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

    t0 = time.perf_counter()
    torch.func.jvp(lambda v: v * 2, (torch.ones(3),), (torch.ones(3),))
    say(f"[first use] torch.func.jvp, first call of the process: "
        f"{time.perf_counter() - t0:.4f} s")

    import dosma_tpu_torch as dt
    from chip_smoke import (
        BIEXP_P0, BIEXP_X, FIT_SHAPE, GENERIC_P0, GENERIC_X, biexp_data, generic_data, offset_exp,
    )
    from dosma_tpu_torch.core.fitting import _as_torch_model
    from dosma_tpu_torch.ops import _build
    from dosma_tpu_torch.ops.generic_lm import build_kernel, compile_model
    from profile_monoexp_fit import _profile

    dev = torch.device("cuda", 0)
    _build.load_library("biexp_lm")
    build_kernel(compile_model(offset_exp, 3))

    # 1-2. Biexponential CurveFitter over volumes on the card.
    Y = biexp_data()
    affine = dt.to_affine(dt.SAGITTAL, spacing=(0.3125, 0.3125, 3.0))
    ys = [dt.MedicalVolume(np.ascontiguousarray(Y[:, t]).reshape(FIT_SHAPE), affine).to(dev)
          for t in range(BIEXP_X.size)]
    fitter = dt.CurveFitter(dt.biexponential, p0=BIEXP_P0, r2_threshold=None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter.fit(BIEXP_X, ys)
    torch.cuda.synchronize()
    say(f"[first use] CurveFitter(biexponential).fit, first call (kernel built): "
        f"{time.perf_counter() - t0:.4f} s")
    say(f"biexp: {Y.shape[0]} voxels x {BIEXP_X.size} echoes on {card}")
    _profile("CurveFitter(biexponential).fit", lambda: fitter.fit(BIEXP_X, ys), args.reps, say)
    del ys

    # 3. curve_fit of a user's model on (5, N) data on the card.
    Yg, _ = generic_data()
    yT = torch.from_numpy(np.ascontiguousarray(Yg.T)).to(dev)
    say(f"offset_exp: {Yg.shape[0]} voxels x {GENERIC_X.size} points on {card}")
    _profile("curve_fit(offset_exp)",
             lambda: dt.curve_fit(offset_exp, GENERIC_X, yT, p0=GENERIC_P0, maxfev=60),
             args.reps, say)

    # 4. Host cost of the routing decisions, per call.
    for name, fn in (("_as_torch_model(biexponential)", lambda: _as_torch_model(dt.biexponential, 4)),
                     ("_as_torch_model(offset_exp)", lambda: _as_torch_model(offset_exp, 3)),
                     ("compile_model(offset_exp)", lambda: compile_model(offset_exp, 3))):
        say(f"[routing] {name}: median {_host_ms(fn):.4f} ms host time per call on {card}")

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
