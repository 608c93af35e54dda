"""How often torch.profiler misses a ``warp_grid`` kernel event.

``chip_smoke.py``'s ``device_ms`` times a kernel from the profiler's trace
and requires one kernel event for every call. This probe runs the same
measurement, the bench-size warp (one 192x192x48 volume, order 1), many
times under three set-ups and counts the kernel events each session saw:

- ``plain``: ``profile(activities=[CUDA])`` entered just before the calls;
- ``with_cpu``: the same with CPU activities too;
- ``warmup``: CUDA activities under ``schedule(wait=0, warmup=1, active=1,
  repeat=1)``: one step of calls that is traced and thrown away, then the
  measured step (``device_ms``'s set-up).

    python tools/profiler_event_probe.py [--sessions 100] [--reps 21]

Needs a CUDA card. Prints one JSON line: for each set-up the histogram of
the counts seen, each session that saw another count than ``--reps``, and
the least, median and largest of the sessions' median kernel times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _session(fn, reps, mode):
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if mode == "with_cpu" else [])
    if mode == "warmup":
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _step in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
    else:
        with profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "warp" in e.name]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sessions", type=int, default=100)
    parser.add_argument("--reps", type=int, default=21)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from dosma_tpu_torch.ops.warp import warp_grid

    dev = torch.device("cuda", 0)
    shape = (192, 192, 48)
    vol = torch.rand((1,) + shape, generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev)
    B = torch.tensor([[0.99, -0.07, 0.0, 1.2], [0.07, 0.99, 0.0, -0.7], [0.0, 0.0, 1.0, 0.4]],
                     dtype=torch.float32, device=dev)

    def fn():
        return warp_grid(vol, B, shape, 1)

    fn()
    torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0), "reps": opts.reps,
           "sessions": opts.sessions}
    for mode in ("plain", "with_cpu", "warmup"):
        counts, short, medians = [], [], []
        for s in range(opts.sessions):
            events = _session(fn, opts.reps, mode)
            us = [e.time_range.elapsed_us() for e in events]
            counts.append(len(events))
            if us:
                medians.append(float(np.median(us)))
            if len(events) != opts.reps:
                short.append({"session": s, "seen": len(events),
                              "median_us": float(np.median(us)) if us else None})
        values, freq = np.unique(counts, return_counts=True)
        out[mode] = {"counts": {int(v): int(f) for v, f in zip(values, freq)}, "short": short,
                     "median_us_min_mid_max": [float(np.min(medians)), float(np.median(medians)),
                                               float(np.max(medians))] if medians else None}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
