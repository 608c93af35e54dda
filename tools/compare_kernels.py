#!/usr/bin/env python3
"""Time the redesigned kernels of one checkout of the port on a CUDA card.

Usage, on a machine with one CUDA card:

    python3 tools/compare_kernels.py --root DIR [--fma]

imports ``dosma_tpu_torch`` from the checkout at DIR (its kernels build into
DIR's own ``dosma_tpu_torch/_build/``) and times, with CUDA events (after
a warm-up):

- the generic LM kernel on chip_smoke.py phase 6's data: a * exp(b x) + c,
  512x512x16 voxels x 5 points, seed 0, max_iter 60;
- the warp kernel on chip_smoke.py phase 8's data: 4 volumes of
  384x384x160 under bench.py's rotation, orders 1 and 3, one launch
  between two events;
- the warp kernel at the registration path's shapes (chip_smoke.py phase
  7): the phantom's moving volume, order 3, 196x196x52 coefficients onto
  192x192x48, NB 1 (``register``'s final warp) and NB 4 (a stacked
  ``apply_warp``), under the phantom's shift and a 0.2 degree rotation;
  and one 192x192x48 volume, order 1, under phase 8's rotation (bench.py's
  warp row). These last three are small, so each of their times is that
  of 50 launches back to back between two events, divided by 50 (the
  wrapper's host work overlaps the card's), and the median of 11; beside
  it, the median duration of the kernel itself over those 50 launches,
  from ``torch.profiler`` (``*_kernel_ms``), which host work cannot
  reach.

``--fma`` also times the checkout's warp kernel built with FMA contraction
(``_build.load_library("warp_grid", fmad=True)``), which the port does not
use, at every warp shape above, and reports its largest |Δ| to the port's
build and the voxels beyond 1e-5 * max(1, |v|).

It prints one JSON line with the card, the root and the times. To compare
two checkouts on one card, run it in turns (A, B, B, A) in one command: two
calls may land on two cards.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

SMALL_REPS = 50  # launches between two events at the registration shapes


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="checkout whose dosma_tpu_torch is timed")
    parser.add_argument("--fma", action="store_true",
                        help="also time the warp kernel built with FMA contraction")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: a CUDA card is required", file=sys.stderr)
        return 1
    root = os.path.abspath(opts.root)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)  # the data and timing of this checkout's smoke test
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    import dosma_tpu_torch
    from dosma_tpu_torch.ops import warp as warp_mod
    from dosma_tpu_torch.ops.generic_lm import _packed_kernel, compile_model
    from dosma_tpu_torch.ops.registration import _world_matrix_to_index_map

    pkg = os.path.dirname(os.path.abspath(dosma_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"dosma_tpu_torch came from {pkg}, not from {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    res = {"root": opts.root, "card": card}

    Y, _ = cs.generic_data()
    yT = torch.from_numpy(np.ascontiguousarray(Y.T)).to(dev)
    x = torch.from_numpy(cs.GENERIC_X).to(dev)
    p0 = torch.tensor(cs.GENERIC_P0, dtype=torch.float32, device=dev)
    program = compile_model(cs.offset_exp, 3)
    res["generic_lm_ms"], res["generic_lm_runs"] = cs.time_ms(
        lambda: _packed_kernel(program, x, yT, p0, 60, 1e-5, 1e-5))
    del yT

    fma_launch = _fma_launcher(warp_mod) if opts.fma else None
    M = np.array([[np.cos(cs.WARP_ANGLE), -np.sin(cs.WARP_ANGLE), 0, cs.WARP_SHIFT[0]],
                  [np.sin(cs.WARP_ANGLE), np.cos(cs.WARP_ANGLE), 0, cs.WARP_SHIFT[1]],
                  [0, 0, 1.0, cs.WARP_SHIFT[2]], [0, 0, 0, 1.0]], np.float32)
    A = torch.from_numpy(cs.WARP_AFFINE.astype(np.float32)).to(dev)
    B = _world_matrix_to_index_map(torch.from_numpy(M).to(dev), A, A)[:3].contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    vols = torch.rand((cs.KNEE_VOLUMES,) + cs.KNEE_SHAPE, generator=gen, device=dev)
    cases = [(f"warp_order{order}", vols, B, cs.KNEE_SHAPE, order, 1) for order in (1, 3)]

    _, moving = cs.registration_phantom()
    stack = torch.from_numpy(np.stack([moving * np.float32(1.0 + 0.1 * i)
                                       for i in range(4)])).to(dev)
    B_reg = torch.from_numpy(cs.rotation_B(cs.REG_SHAPE, 0.2, cs.REG_SHIFT)).to(dev)
    bench_vol = torch.rand((1,) + cs.REG_SHAPE, generator=gen, device=dev)
    cases += [("register_order3_nb1", stack[:1], B_reg, cs.REG_SHAPE, 3, SMALL_REPS),
              ("apply_warp_order3_nb4", stack, B_reg, cs.REG_SHAPE, 3, SMALL_REPS),
              ("bench_order1_nb1", bench_vol, B, cs.REG_SHAPE, 1, SMALL_REPS)]

    def timings(key, fn, reps):
        res[f"{key}_ms"], res[f"{key}_runs"] = _time(cs, fn, reps)
        if reps > 1:
            res[f"{key}_kernel_ms"] = cs.device_ms(fn, reps, "warp")

    for name, v, Bc, out_shape, order, reps in cases:
        srcs = warp_mod.prepare_sources(v, order)
        timings(name, lambda: warp_mod.warp_grid(srcs, Bc, out_shape, order), reps)
        if fma_launch is not None:
            got = warp_mod.warp_grid(srcs, Bc, out_shape, order)
            fma = fma_launch(srcs, Bc, out_shape, order)
            diff = (fma - got).abs().nan_to_num(0)
            timings(f"{name}_fma", lambda: fma_launch(srcs, Bc, out_shape, order), reps)
            res[f"{name}_fma_max_abs_diff"] = float(diff.max())
            res[f"{name}_fma_beyond_tolerance"] = int(
                (diff > cs.TOL * got.abs().clamp(min=1.0)).sum())
            del got, fma, diff
        del srcs
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


def _time(cs, fn, reps):
    """Median and all of the CUDA-event times of ``reps`` back-to-back
    calls of ``fn``, each divided by ``reps``: 5 times of one call, or 11
    of several."""
    def block():
        for _ in range(reps):
            fn()
    med, runs = cs.time_ms(block, 5 if reps == 1 else 11)
    return med / reps, [t / reps for t in runs]


def _fma_launcher(warp_mod):
    """``warp_mod._launch`` on the FMA build of warp_grid.cu: the wrapper's
    own checks and arguments, the other library's entry."""
    from dosma_tpu_torch.ops._build import load_library

    port_fn = warp_mod._kernel_fn
    fma_fn = load_library("warp_grid", fmad=True).dosma_warp_grid
    fma_fn.argtypes, fma_fn.restype = port_fn().argtypes, port_fn().restype

    def launch(*args):
        warp_mod._kernel_fn = lambda: fma_fn
        try:
            return warp_mod._launch(*args)
        finally:
            warp_mod._kernel_fn = port_fn
    return launch


if __name__ == "__main__":
    sys.exit(main())
