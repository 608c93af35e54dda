#!/usr/bin/env python3
"""Time the hand-written kernels of one checkout of the port on a CUDA card.

Usage, on a machine with one CUDA card:

    python3 tools/compare_kernels.py --root DIR [--sweep] [--sass]
    python3 tools/compare_kernels.py --turns DIR_A DIR_B [--sass]

``--root`` imports ``dosma_tpu_torch`` from the checkout at DIR (its kernels
build into DIR's own ``dosma_tpu_torch/_build/``) and times, with CUDA
events (after a warm-up):

- the monoexp LM kernel on chip_smoke.py phase 4's data (config1:
  512x512x64 voxels x 4 echoes, noise 0.005, seed 0, the log-linear seed in
  the kernel, max_iter 100), and the biexp LM kernel on phase 5's data
  (512x512x16 voxels x 8 uniform echoes, noiseless, seed 0, max_iter 100);
  beside each, the SHA-256 of its packed output rows, so that two
  checkouts' outputs can be compared bit for bit;
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

``--sweep`` times the monoexp and biexp kernels built with each of three
``__launch_bounds__`` settings (``kThreads`` threads a block and
``kMinBlocks`` resident blocks an SM, which cap a thread's registers, in
``csrc/monoexp_lm.cu`` and ``csrc/biexp_lm.cu``; see SWEEP), each with its
registers and spill bytes from ptxas and its output's digest.

``--sass`` counts, with ``cuobjdump -sass``, the instructions of the LM
kernels' instantiations on these paths (monoexp T = 4 uniform, biexp T = 8)
and of their LM loop: the span of the function's longest backward branch,
whose body is one iteration on the path where no division takes its slow
path (those are called out of line).

Each run prints one JSON line with the card, the root and the numbers.
``--turns A B`` runs ``--root`` on A, B, B, A in turn (four processes, one
card: two calls of the tool may land on two cards), prints their lines,
then one JSON line with each root's median of every time and whether B's
monoexp and biexp rows are bit-identical to A's.
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

SMALL_REPS = 50  # launches between two events at the registration shapes
LM_REPS = 10  # LM kernel launches between two events (median of 11)
# (threads, minimum blocks) for --sweep: the compiler's choice and two caps
SWEEP = {"monoexp_lm": ((256, 1), (256, 5), (256, 6)),
         "biexp_lm": ((256, 1), (128, 5), (256, 3))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    target = parser.add_mutually_exclusive_group(required=True)
    target.add_argument("--root", help="checkout whose dosma_tpu_torch is timed")
    target.add_argument("--turns", nargs=2, metavar=("A", "B"),
                        help="time checkouts A and B in turns A, B, B, A")
    parser.add_argument("--sweep", action="store_true",
                        help="also time the LM kernels at three launch-bounds settings")
    parser.add_argument("--sass", action="store_true",
                        help="count the LM kernels' SASS instructions")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: a CUDA card is required", file=sys.stderr)
        return 1
    if opts.turns:
        return _turns(opts)
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

    _lm_kernels(cs, dev, res, opts)
    if opts.sass:
        _sass(res)

    Y, _ = cs.generic_data()
    yT = torch.from_numpy(np.ascontiguousarray(Y.T)).to(dev)
    x = torch.from_numpy(cs.GENERIC_X).to(dev)
    p0 = torch.tensor(cs.GENERIC_P0, dtype=torch.float32, device=dev)
    program = compile_model(cs.offset_exp, 3)
    res["generic_lm_ms"], res["generic_lm_runs"] = cs.time_ms(
        lambda: _packed_kernel(program, x, yT, p0, 60, 1e-5, 1e-5))
    del yT

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
        del srcs
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


def _lm_kernels(cs, dev, res, opts):
    """The monoexp and biexp kernels of the checkout on phases 4 and 5's
    data: times, output digests, and with opts.sweep the launch-bounds
    sweep."""
    from dosma_tpu_torch.ops import biexp as biexp_mod
    from dosma_tpu_torch.ops import monoexp as mono_mod

    Y, _, _ = cs.config1_data(seed=0)
    yT = torch.from_numpy(np.ascontiguousarray(Y.T)).to(dev)
    del Y
    x = torch.from_numpy(cs.ECHO_TIMES).to(dev)
    margs = (x, yT, None, 100, 1e-5, 1e-5, True)
    res["monoexp_lm_ms"], res["monoexp_lm_runs"] = _time(
        cs, lambda: mono_mod._packed_kernel(*margs), LM_REPS)
    rows = mono_mod._packed_kernel(*margs)
    res["monoexp_rows_sha256"] = _digest(rows)
    if opts.sweep:
        _sweep(cs, res, mono_mod, "monoexp_lm", margs)
    del rows, yT
    torch.cuda.empty_cache()

    yT = torch.from_numpy(np.ascontiguousarray(cs.biexp_data().T)).to(dev)
    x = torch.from_numpy(cs.BIEXP_X).to(dev)
    p0 = torch.tensor(cs.BIEXP_P0, dtype=torch.float32, device=dev)
    bargs = (x, yT, p0, 100, 1e-5, 1e-5)
    if len(inspect.signature(biexp_mod._packed_kernel).parameters) == 7:
        bargs += (biexp_mod._uniform_path(cs.BIEXP_X),)  # the e0 * q^t columns, where taken
    res["biexp_lm_ms"], res["biexp_lm_runs"] = _time(
        cs, lambda: biexp_mod._packed_kernel(*bargs), LM_REPS)
    rows = biexp_mod._packed_kernel(*bargs)
    res["biexp_rows_sha256"] = _digest(rows)
    if opts.sweep:
        _sweep(cs, res, biexp_mod, "biexp_lm", bargs)
    del rows, yT
    torch.cuda.empty_cache()


def _sweep(cs, res, mod, name, args):
    """``mod._packed_kernel(*args)`` on builds of ``csrc/<name>.cu`` with
    each SWEEP setting of its kThreads and kMinBlocks."""
    from dosma_tpu_torch.ops import _build

    source = (_build._CSRC / f"{name}.cu").read_text()
    patterns = (r"constexpr int kThreads = \d+;", r"constexpr int kMinBlocks = \d+;")
    if not all(re.search(p, source) for p in patterns):
        raise RuntimeError(f"{name}.cu of this root has no kThreads / kMinBlocks to sweep")
    port_fn = mod._kernel_fn
    for threads, blocks in SWEEP[name]:
        text = re.sub(patterns[0], f"constexpr int kThreads = {threads};", source)
        text = re.sub(patterns[1], f"constexpr int kMinBlocks = {blocks};", text)
        lib = _build.load_generated(f"{name}_{threads}x{blocks}", text)
        fn = getattr(lib, port_fn().__name__)
        fn.argtypes, fn.restype = port_fn().argtypes, port_fn().restype
        key = f"{name}_{threads}x{blocks}"
        mod._kernel_fn = lambda *_, fn=fn: fn
        try:
            res[f"{key}_ms"], res[f"{key}_runs"] = _time(
                cs, lambda: mod._packed_kernel(*args), LM_REPS)
            res[f"{key}_rows_sha256"] = _digest(mod._packed_kernel(*args))
        finally:
            mod._kernel_fn = port_fn
        res[f"{key}_ptxas"] = {_short(k): v for k, v in
                               cs.ptxas_kernels(lib.build_log.read_text()).items()
                               if re.search(r"kernelILi[48]ELb1E", k)}


def _sass(res):
    """Static SASS counts of the LM kernels' instantiations on phases 4 and
    5's paths: the whole function, and its LM loop with its mix."""
    from dosma_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for lib_name, pattern in (("monoexp_lm", r"monoexp_lm_kernelILi4ELb1E"),
                              ("biexp_lm", r"biexp_lm_kernelILi8E(?:Lb1E)?E")):
        path = _build.load_library(lib_name)._name
        sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        funcs = {}
        for chunk in sass.split("Function : ")[1:]:
            funcs[chunk.split("\n", 1)[0].strip()] = chunk
        names = [k for k in funcs if re.search(pattern, k)]
        if len(names) != 1:
            raise RuntimeError(f"{lib_name}: {len(names)} SASS functions match {pattern}")
        res[f"{lib_name}_sass"] = _loop_counts(funcs[names[0]])


def _loop_counts(text):
    """Instructions of one SASS function and of the span of its longest
    backward branch (its outermost loop), with the loop's mix by opcode
    family."""
    ins, labels, pending = [], {}, []
    for line in text.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
            labels.update({name: ins[-1][0] for name in pending})
            pending = []
    body = [(a, op) for a, op in ins if not op.startswith("NOP")]
    loops = []
    for a, op in body:  # a branch target is an address or a label
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", op)
        if m:
            dest = labels.get(m.group(1)) if m.group(1).startswith(".L") else int(m.group(1), 16)
            if dest is not None and dest < a:
                loops.append((dest, a))
    out = {"function_instructions": len(body)}
    if loops:
        lo, hi = max(loops, key=lambda s: s[1] - s[0])
        loop = [op for a, op in body if lo <= a <= hi]
        mix = {}
        for op in loop:
            word = op.split()[1] if op.startswith("@") else op.split()[0]
            family = word.split(".")[0]
            if family in ("FMUL", "FADD", "FFMA", "MUFU", "FSETP", "FSEL", "SEL", "FMNMX",
                          "CALL", "ISETP", "LDS", "LDG"):
                mix[family] = mix.get(family, 0) + 1
        out.update(loop_instructions=len(loop), loop_mix=mix)
    return out


def _short(mangled):
    m = re.search(r"(\w+?_kernel)(I.*?E)E", mangled)
    return m.group(1) + m.group(2) if m else mangled


def _digest(t):
    torch.cuda.synchronize()
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _time(cs, fn, reps):
    """Median and all of the CUDA-event times of ``reps`` back-to-back
    calls of ``fn``, each divided by ``reps``: 5 times of one call, or 11
    of several."""
    def block():
        for _ in range(reps):
            fn()
    med, runs = cs.time_ms(block, 5 if reps == 1 else 11)
    return med / reps, [t / reps for t in runs]


def _turns(opts):
    """--root on A, B, B, A in four processes; their lines, then each
    root's median of every time and whether B's LM rows equal A's."""
    a, b = opts.turns
    flags = ["--sass"] if opts.sass else []
    lines = []
    for root in (a, b, b, a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root, *flags],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"compare_kernels: --root {root} failed ({proc.returncode})", file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(json.loads(line))
    summary = {"card": lines[0]["card"], "order": [a, b, b, a]}
    for label, runs in (("A", (lines[0], lines[3])), ("B", (lines[1], lines[2]))):
        summary[label] = {k: statistics.median([r[k] for r in runs]) for k in runs[0]
                          if k.endswith("_ms") and all(k in r for r in runs)}
    for kernel in ("monoexp", "biexp"):
        key = f"{kernel}_rows_sha256"
        summary[f"{kernel}_rows_identical"] = (
            lines[0][key] == lines[1][key] == lines[2][key] == lines[3][key])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
