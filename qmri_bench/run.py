"""Benchmark of ``dosma_tpu_torch`` on one NVIDIA card: one cell a run.

    python3 -m qmri_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
shapes and recipe) and a traffic mix (``traffic/<name>.json``: the request
kind, the pool of scans, what is kept for the check). The request kind is
the module ``requests/<kind>.py``; every metric is read by
``metrics/<metric>.py``; the limits of the numbers that decide ``correct``
are in ``limits/<cell>.json``. A new cell, mix or metric is new files and
new entries in ``BENCHMARK.json``.

A run makes its inputs on the card from the seed, warms up the cell's own
shapes (set-up, ``setup_s``), then sends requests in a closed loop from one
client for ``--seconds``; the request running at the close is finished and
counted. With ``--trace 0`` it reports the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, from spans recorded in the window and a
profiler session over a few requests after it. Then the program's state is
freed and the plain reference judges the kept answers. The last line of
standard output is one JSON object; the numbers compared, with their
limits, are the last lines of standard error and the ``checks`` key.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dosma_tpu")


def process_start_time() -> float:
    """Wall-clock time at which this process started (Linux), else the
    time this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return min(_T_IMPORT, btime + int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, StopIteration, IndexError, ValueError):
        return _T_IMPORT


def forbidden_modules(modules=None):
    """Top-level names in ``modules`` (default ``sys.modules``) that are JAX's
    or the JAX package's, compared whole."""
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def with_held(spec):
    """``spec`` with the cells and metrics of ``held.json`` added: cells proved
    correct but held out of ``BENCHMARK.json``, since no bound it allows holds
    their end-to-end metric."""
    held = load_json(BENCH_DIR / "held.json")
    return {**spec, **{sec: spec[sec] + held[sec]
                       for sec in ("workloads", "end_to_end", "per_layer")}}


def load_cell(name: str, spec=None):
    """(spec, cell, configuration, traffic, limits) of the cell ``name``; a
    held cell comes with ``spec`` widened by :func:`with_held`."""
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        spec = with_held(spec)
        cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
    return spec, cell, cfg, traffic, limits


def metrics_of(spec, cell_name: str, section: str):
    """The entries of ``section`` that the cell reports."""
    return [m for m in spec[section] if cell_name in m.get("workloads", [cell_name])]


def reader(metric_name: str):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"qmri_bench_metric_{metric_name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name, seed, seconds, trace, device, spec=None, cfg_override=None,
             traffic_override=None, start=None, log=sys.stderr, control=False):
    """One run of the cell ``name`` on ``device``: the result object. With
    ``control`` the result also holds the numbers that the reference in the
    next lower precision gives in the program's place (``control.py``)."""
    import torch

    from qmri_bench.tracing import Spans, profile_requests

    start = process_start_time() if start is None else start
    spec, cell, cfg, traffic, limits = load_cell(name, spec)
    cfg.update(cfg_override or {})
    traffic.update(traffic_override or {})
    # Torch's host threads as the configuration's deployment has them.
    torch.set_num_threads(int(cfg["host_threads"]))
    kind = importlib.import_module(f"qmri_bench.requests.{traffic['request']}")
    wl = kind.Workload(cfg, traffic, seed, device)

    # Set-up: inputs from the seed, then the cell's own shapes warmed up.
    wl.setup()
    quiet = Spans(False, device)
    for k in range(int(traffic["warmup"])):
        wl.request(k, quiet)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    spans = Spans(bool(trace), device)
    keep_all = traffic["keep"] == "all"
    sample = set() if keep_all else set(
        random.Random(seed).sample(range(4 * int(traffic["pool"])), int(traffic["keep"]) - 1))
    latencies, attempted, failed, last = [], 0, 0, None
    t_setup = time.time()
    t0 = time.perf_counter()
    while True:
        t_r = time.perf_counter()
        try:
            out = wl.request(attempted, spans)
        except Exception:  # a failed request is counted and reported, and the run goes on
            traceback.print_exc(file=log)
            out = None
            failed += 1
        t_e = time.perf_counter()
        if out is not None:
            latencies.append(t_e - t_r)
            if keep_all or attempted in sample:
                wl.keep(out)
            else:
                last = out
        attempted += 1
        if t_e - t0 >= seconds:
            break
    window_s = t_e - t0
    if last is not None:
        wl.keep(last)
    last = out = None
    _sync(device)
    spans.collect()

    traced = None
    if trace:
        n = int(traffic["trace_requests"])
        traced = profile_requests(lambda i: wl.request(attempted + i, Spans(False, device)), n,
                                  device, traffic.get("trace_warmup"))
        if traced is not None:
            print(f"trace: {traced['requests']} requests in {traced['window_s']:.6f} s, "
                  f"{traced['device_events']} device events, {traced['launches']} launch calls, "
                  f"busy {traced['busy_s']:.6f} s", file=log)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    ctx = {"cell": cell, "cfg": cfg, "traffic": traffic, "workload": wl, "spans": spans,
           "trace": traced, "latencies": latencies, "window_s": window_s,
           "completed": len(latencies), "setup_s": t_setup - start}
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, name, section):
        value = reader(m["name"])(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(f"window: {len(latencies)} requests completed of {attempted} attempted in "
          f"{window_s:.6f} s; latency samples {len(latencies)}", file=log)
    if latencies:
        lat = sorted(latencies)
        print("latency ms: min {:.3f} median {:.3f} max {:.3f}; in order {}".format(
            lat[0] * 1e3, lat[len(lat) // 2] * 1e3, lat[-1] * 1e3,
            [round(t * 1e3, 3) for t in latencies[:40]]), file=log)

    # The check: the program's state freed, the reference on the kept answers.
    wl.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    try:
        numbers = wl.numbers()
    except Exception:  # an answer the reference cannot read is not correct
        traceback.print_exc(file=log)
        numbers = {}
    print(f"check: {time.perf_counter() - t_check:.3f} s for {len(wl.kept)} kept answers",
          file=log)
    checks = {k: {"value": numbers.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
    correct = failed == 0 and bool(latencies) and all(
        c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if traced is not None:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    if control:
        result["control"] = wl.numbers(control=True)
    result["checks"] = checks
    return result


def _json_number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    start = process_start_time()

    try:
        import dosma_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"the program under test does not import: {e}", file=sys.stderr)
        return 2
    import torch

    spec, cell, *_ = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"no result: the cell needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(args.workload, args.seed, args.seconds, args.trace, device, spec=spec,
                      start=start)

    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {_json_number(c['value'])} limit {c['limit']}", file=sys.stderr)
    result["checks"] = {k: {"value": _json_number(c["value"]), "limit": c["limit"]}
                        for k, c in result["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
