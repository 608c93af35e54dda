"""Spans of the benchmark's own and the reduction of a profiler trace.

Spans: in a traced run every request records, around each call into a
layer, a pair of CUDA events (host clock on the CPU); the medians over the
window's requests are the per-layer times. The program records no span of
its own yet.

Trace: a ``torch.profiler`` session over a few requests after the window,
with one warm-up step that is thrown away (a session without it loses
kernel events, ``chip_smoke.py::device_ms``). Its events are reduced in
memory and nothing is written to disk: device busy time (the union of
kernels, copies and sets on the card), kernel times by name, copy times by
direction, launch calls made by the host, and the longest idle gaps named
by what the host was doing.
"""

from __future__ import annotations

import contextlib
import re
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

__all__ = ["Spans", "profile_requests"]

REQUEST = "qmri_bench.request"
_LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
             "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel"}
_RUNTIME = re.compile(r"^(cuda|cu|nccl)[A-Z]")


class Spans:
    """Named spans per request; inert unless ``on``."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.cuda = device.type == "cuda"
        self._open = []  # (name, start, end) of the window's requests, read at the end
        self.ms = defaultdict(list)

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = self._mark() if self.on else None
        with torch.profiler.record_function(f"qmri_bench.{name}"):
            yield
        if self.on:
            self._open.append((name, start, self._mark()))

    def collect(self):
        """Turn the recorded marks into ms; call after the device is idle."""
        for name, start, end in self._open:
            ms = start.elapsed_time(end) if self.cuda else (end - start) * 1e3
            self.ms[name].append(ms)
        self._open.clear()

    def median(self, name: str):
        vals = self.ms.get(name)
        return statistics.median(vals) if vals else None


def _union_seconds(intervals, lo, hi):
    """Seconds covered by ``intervals`` (ns pairs) inside [lo, hi], and the
    gaps between them."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, prev = [], lo
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    return sum(e - s for s, e in merged) / 1e9, gaps


def _short(name: str) -> str:
    """A kernel's name without ``void`` and past 160 characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= 160 else name[:157] + "..."


def _reduce(events, n_requests):
    """The trace of the active step as plain numbers. Events are told apart
    by device and name (the profiler's activity kinds are not exposed in
    every torch): on the card, copies and sets by their names and every
    other event a kernel, except the card's copies of the annotations
    (``qmri_bench.*``, ``ProfilerStep*``) and runtime calls."""
    requests, device, cpu_ops, launches = [], [], [], []
    kernels = defaultdict(list)
    copies = defaultdict(float)
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if name in _LAUNCHES:
            launches.append(start)
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            if not (name.startswith(("qmri_bench.", "ProfilerStep")) or _RUNTIME.match(name)):
                device.append((start, end, name))
        elif name == REQUEST:
            requests.append((start, end))
        else:
            cpu_ops.append((start, end, name))
    if not requests:
        return None
    lo = min(s for s, _ in requests)
    hi = max(e for _, e in requests)
    inside = [d for d in device if d[1] > lo and d[0] < hi]
    busy_s, gaps = _union_seconds([(s, e) for s, e, _ in inside], lo, hi)
    ops = defaultdict(float)
    for s, e, name in inside:
        ops[name] += (e - s) / 1e9
        if not name.startswith(("Memcpy", "Memset")):
            kernels[name].append((e - s) / 1e9)
        elif name.startswith("Memcpy"):
            for direction in ("HtoD", "DtoH", "DtoD"):
                if direction in name:
                    copies[direction] += (e - s) / 1e9
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    if cpu_ops:
        c = np.array([(s, e) for s, e, _ in cpu_ops], dtype=np.int64)
        names = [n for _, _, n in cpu_ops]
    idle = []
    for a, b in gaps:
        label = "no host span"
        if cpu_ops:
            mid = (a + b) // 2
            hit = np.flatnonzero((c[:, 0] <= mid) & (c[:, 1] >= mid))
            if hit.size:
                label = names[hit[np.argmin(c[hit, 1] - c[hit, 0])]]
        idle.append([label, (b - a) / 1e9])
    return {
        "requests": n_requests,
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy_s,
        "kernels": dict(kernels),
        "copies": dict(copies),
        "launches": sum(1 for t in launches if lo <= t <= hi),
        "device_ops": sorted(([_short(n), s] for n, s in ops.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": idle,
        "device_events": len(inside),
    }


def _tiny_work(device):
    """A warm-up step's worth of small launches, for requests too long to
    trace twice."""
    x = torch.zeros(1024, device=device)
    for _ in range(256):
        x.add_(1.0)


def profile_requests(run_request, n: int, device: torch.device, warm: int = None):
    """Trace ``n`` requests (``run_request(i)``) after a warm-up step of
    ``warm`` more (``n`` by default; 0: small launches only); returns the
    reduced trace, or None where the session saw no request."""
    warm = n if warm is None else warm
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    captured = {}

    def ready(prof):
        captured["events"] = prof.profiler.kineto_results.events()

    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for step, count in enumerate((warm, n)):
            if not count:
                _tiny_work(device)
            for i in range(count):
                if step:
                    with torch.profiler.record_function(REQUEST):
                        run_request(warm + i)
                else:
                    run_request(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.step()
    events = captured.get("events")
    return _reduce(events, n) if events is not None else None
