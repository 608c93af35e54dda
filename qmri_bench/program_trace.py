"""The program's own spans and counters, read in a traced run.

``dosma_tpu_torch`` records its stages as ``dosma.*`` spans, CPU events on
the profiler's clock beside the card's kernels and copies, and keeps integer
counters (``dosma_tpu_torch.utils.profiling.counters``). The readers of the
metrics that need them call :func:`program_trace`. It makes one profiler
session, the same schedule as ``tracing.profile_requests`` (a warm-up step
thrown away, then the cell's ``trace_requests`` requests, each inside the
``qmri_bench.request`` span), and keeps its reduction in the run's context
for every reader. The counters are read before and after the active step.

:func:`reduce_program` gives, per span name, the count, the host seconds and
the self seconds (the duration less the span's children); ``idle_s``, the
card-idle time of the window (every gap between kernels, copies and sets)
during which that span was the innermost open ``dosma.*`` span, the rest
under ``"(outside)"``; and ``syncs``, the host's waits on the card
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) that started while it was the innermost.

A program without counters (one older than its spans) gives None, and every
reader of this module reports nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from qmri_bench.tracing import _RUNTIME, REQUEST, Spans, _tiny_work

__all__ = ["OUTSIDE", "program_trace", "reduce_program", "per_request"]

PREFIX = "dosma."
OUTSIDE = "(outside)"
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"}
_KEY = "program_trace"


def program_trace(ctx):
    """The reduced session of the program's spans and counters; made once a
    run, on the first call. None without a traced run or without the
    program's counters."""
    if _KEY not in ctx:
        ctx[_KEY] = _session(ctx)
    return ctx[_KEY]


def _session(ctx):
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from dosma_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)  # None in a program without spans
    if ctx["trace"] is None or counters is None:
        return None

    wl, traffic = ctx["workload"], ctx["traffic"]
    device = wl.device
    n = int(traffic["trace_requests"])
    warm = traffic.get("trace_warmup")
    warm = n if warm is None else int(warm)
    first = ctx["completed"] + warm + n  # past the requests traced by tracing.py
    quiet = Spans(False, device)
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
            before = dict(counters)
            for i in range(count):
                k = first + step * warm + i
                if step:
                    with record_function(REQUEST):
                        wl.request(k, quiet)
                else:
                    wl.request(k, quiet)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            delta = {k: v - before.get(k, 0) for k, v in counters.items()
                     if v != before.get(k, 0)}
            prof.step()
    events = captured.get("events")
    return reduce_program(events, n, delta) if events is not None else None


def _gaps(device, lo, hi):
    """(starts, ends) of the gaps in [lo, hi] between the device intervals."""
    if not device:
        return np.array([lo], np.int64), np.array([hi], np.int64)
    d = np.clip(np.array(device, np.int64), lo, hi)
    d = d[d[:, 1] > d[:, 0]]
    d = d[np.argsort(d[:, 0], kind="stable")]
    run_end = np.maximum.accumulate(d[:, 1])
    starts = np.concatenate([[lo], run_end])
    ends = np.concatenate([d[:, 0], [hi]])
    keep = ends > starts
    return starts[keep], ends[keep]


def _innermost(spans, lo, hi):
    """Segments (starts, ends, labels) covering [lo, hi] and every span, each
    labelled by the innermost open span's index, -1 where none is open."""
    bounds = sorted([(s, 1, i) for i, (s, e, _) in enumerate(spans) if e > s]
                    + [(e, 0, i) for i, (s, e, _) in enumerate(spans) if e > s])
    seg_s, seg_e, seg_l = [], [], []
    stack, prev = [], min(lo, bounds[0][0]) if bounds else lo
    for t, opens, i in bounds:
        if t > prev:
            seg_s.append(prev)
            seg_e.append(t)
            seg_l.append(stack[-1] if stack else -1)
            prev = t
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    if hi > prev:
        seg_s.append(prev)
        seg_e.append(hi)
        seg_l.append(-1)
    return np.array(seg_s, np.int64), np.array(seg_e, np.int64), np.array(seg_l, np.int64)


def reduce_program(events, n_requests, counters=None):
    """The program's spans of a session's events, as plain numbers (module
    docstring); None where the session saw no request."""
    requests, device, spans, syncs = [], [], [], []
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if name in SYNCS:
            syncs.append(start)
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            # The card's copies of annotations and runtime calls are no work.
            if not (name.startswith(("qmri_bench.", "ProfilerStep", PREFIX))
                    or _RUNTIME.match(name)):
                device.append((start, end))
        elif name == REQUEST:
            requests.append((start, end))
        elif name.startswith(PREFIX):
            spans.append((start, end, name))
    if not requests:
        return None
    lo = min(s for s, _ in requests)
    hi = max(e for _, e in requests)
    spans = [sp for sp in spans if sp[1] > lo and sp[0] < hi]
    names = [name for _, _, name in spans]

    gap_s, gap_e = _gaps(device, lo, hi)
    cum = np.concatenate([[0], np.cumsum(gap_e - gap_s)])

    def idle_until(t):
        """Idle ns in [lo, t], for an array of t."""
        if not gap_s.size:
            return np.zeros_like(t)
        t = np.clip(t, lo, hi)
        k = np.searchsorted(gap_s, t, side="right")
        over = np.where(k > 0, np.maximum(gap_e[np.maximum(k - 1, 0)] - t, 0), 0)
        return cum[k] - over

    seg_s, seg_e, seg_l = _innermost(spans, lo, hi)
    seg_idle = idle_until(seg_e) - idle_until(seg_s)
    label = [names[i] if i >= 0 else OUTSIDE for i in seg_l]

    table = {}
    for s, e, name in spans:
        row = table.setdefault(name, {"count": 0, "host_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["host_s"] += (e - s) / 1e9
    idle = {OUTSIDE: 0.0}
    for name, length, gone in zip(label, seg_e - seg_s, seg_idle):
        if name != OUTSIDE:
            table[name]["self_s"] += float(length) / 1e9
        idle[name] = idle.get(name, 0.0) + float(gone) / 1e9
    waits = {OUTSIDE: 0}
    t = np.array([s for s in syncs if lo <= s <= hi], np.int64)
    if t.size and seg_s.size:
        at = np.searchsorted(seg_s, t, side="right") - 1
        for j in at:
            name = label[j] if j >= 0 else OUTSIDE
            waits[name] = waits.get(name, 0) + 1
    return {
        "requests": n_requests,
        "window_s": (hi - lo) / 1e9,
        "idle_total_s": float(cum[-1]) / 1e9,
        "spans": table,
        "idle_s": idle,
        "syncs": waits,
        "counters": dict(counters or {}),
    }


def per_request(ctx, key, prefix=PREFIX):
    """The sum of ``key`` (``"idle_s"`` or ``"syncs"``) over the spans whose
    names start with ``prefix``, per traced request; None where the program
    recorded no such span."""
    prog = program_trace(ctx)
    if prog is None or not any(name.startswith(prefix) for name in prog["spans"]):
        return None
    total = sum(v for name, v in prog[key].items() if name.startswith(prefix))
    return total / prog["requests"]
