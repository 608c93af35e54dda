"""Tracing and profiling (counterpart of ``dosma_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` session around a block (the CPU, and
  the cards when CUDA is available), written as a Chrome trace into
  ``log_dir`` (open it in Perfetto or ``chrome://tracing``);
- :func:`annotate`: a named region (``torch.profiler.record_function``),
  shown in such traces;
- :class:`StageTimer`: named wall-clock stage timers with a printable
  report, as in ``dosma_tpu``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch

__all__ = ["trace", "annotate", "StageTimer"]

_logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``log_dir/trace_<pid>_<ns>.json``.

    Example::

        with profiling.trace("/tmp/trace") as prof:
            fitter.fit(x, y)
        print(prof.trace_path)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """Named region for traces (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Named wall-clock stage timers with a printable report.

    Example::

        timer = StageTimer(verbose=True)
        with timer("load"):
            vols = dt.read(path)
        with timer("fit"):
            fitter.fit(x, vols)
        print(timer.report())
    """

    def __init__(self, verbose: bool = False, logger: Optional[logging.Logger] = None):
        self.verbose = verbose
        self._logger = logger or _logger
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if self.verbose:
                self._logger.info(f"[{name}] {dt:.3f}s")

    def report(self) -> str:
        if not self.times:
            return "(no stages timed)"
        width = max(len(k) for k in self.times)
        total = sum(self.times.values())
        lines = [f"{k.ljust(width)}  {v:8.3f}s" for k, v in self.times.items()]
        lines.append(f"{'total'.ljust(width)}  {total:8.3f}s")
        return "\n".join(lines)
