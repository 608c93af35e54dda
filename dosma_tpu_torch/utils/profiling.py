"""Tracing and profiling (counterpart of ``dosma_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` session around a block (the CPU, and
  the cards when CUDA is available), written as a Chrome trace into
  ``log_dir`` (open it in Perfetto or ``chrome://tracing``);
- :func:`annotate`: a named region, recorded only while a profiler session
  is active (a shared no-op context otherwise);
- :data:`counters` and :func:`count`: integer counters that are always on;
- :class:`StageTimer`: named wall-clock stage timers with a printable
  report, as in ``dosma_tpu``.

The package's own spans, recorded by any ``torch.profiler`` session (this
one's :func:`trace` included) beside the kernels and copies of the card:

- ``dosma.fit`` (``MonoExponentialFit.fit``) and its stages
  ``dosma.fit.prepare`` (checks, ``reformat``, the mask's alignment),
  ``dosma.fit.stack`` (host volumes' float32 echo stack and its one
  crossing to the compute device), ``dosma.fit.lm`` (on a card the
  layout of the kernel's inputs in ``ops/monoexp.py::_maps``: casts, the
  stack of more than eight rows, the mask's cast and crossing; and the
  one launch of ``monoexp_lm``'s maps entry; on the CPU ``monoexp_lm``
  with its small copies and NaN policy), ``dosma.fit.post`` (on the CPU: bounds, r², mask,
  ``nan_to_num``, rounding; a card's kernel does them) and
  ``dosma.fit.maps`` (reshape, the host copy back, headers, the volumes);
  ``dosma.fit.scan`` around it in a scan's map method;
- ``dosma.rows`` (``QuantitativeValue.metric_rows``) and its stages
  ``dosma.rows.gather`` (the mask's crossing, ``region_stats``' launches,
  and the per-region gathers when ``fns`` are given) and
  ``dosma.rows.summary`` (the statistics read back, once, and the rows);
- ``dosma.register.level`` (one pyramid level of a matrix stage), with
  ``dosma.register.prep`` (smoothing, draws, the fixed side's samples) and
  ``dosma.register.adam`` (the level's Adam loop), and
  ``dosma.register.warp`` (a chain's final warp);
- ``dosma.segment`` (every segmentation model's ``generate_mask``) and its
  stages ``dosma.segment.stage`` (the volume to the device, the RSS of two
  echoes, ``reformat`` to sagittal, and, entered again beside the
  network, the cast and the whitening statistics), ``dosma.segment.forward``
  (the batches through whitening, the network and the threshold, each
  writing its ``(B, H, W, C)`` uint8 masks into one tensor on the device),
  ``dosma.segment.copy`` (that tensor's one dense device-to-host copy),
  ``dosma.segment.unpack`` (the host step between the copy and the
  returned array: a numpy view of the copy, no per-voxel work) and
  ``dosma.segment.masks`` (the category volumes and the reformat back);
- ``dosma.train`` (``SegTrainer.step``) and its stages ``dosma.train.place``
  (the batch made float32 on the host and its crossing), ``.forward`` (the
  forward and the loss), ``.backward`` (``loss.backward()`` and, on several
  ranks, the gradients' all-reduce), ``.optimizer`` (the Adam step) and
  ``.loss`` (the loss read back).

Counters: ``h2d.bytes`` (bytes of host tensors or arrays copied to a card
by :func:`dosma_tpu_torch.core.device.as_tensor`), ``adam.iterations``
(iterations of the matrix stages' Adam loops), ``segment.slices`` (slices
through a segmentation network) and ``segment.mask_bytes`` (bytes of its
masks' copies to the host: one byte a voxel and class, S·H·W·C a call),
and the hand-written
kernels' launches ``monoexp_lm.launches``, ``biexp_lm.launches``,
``generic_lm.launches``, ``warp_grid.launches`` and
``region_stats.launches`` (one a call of the region statistics' kernel
chain, ``ops/analytics.py::region_stats`` on a card's map),
``region_stats.host_maps`` (``metric_rows`` calls whose host map crossed
to a card for its statistics), and
``fit.echoes_in_place`` (fits whose echo rows ``monoexp_lm``'s maps entry
read where they lie, with no stacked copy).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import Counter
from typing import Dict, Optional

import torch
from torch.autograd import _profiler_enabled

__all__ = ["trace", "annotate", "counters", "count", "StageTimer"]

_logger = logging.getLogger(__name__)

# A record function of the FUNCTION scope: a CPU event of the profiler, as an
# aten op is. ``torch.profiler.record_function`` (the USER scope) would also
# put a copy of each span on the card's timeline, where a reader of the trace
# would take it for device work.
_record = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()

counters: Counter = Counter()


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
    """Named region for traces: a record function while a profiler session
    is active, else a shared no-op context (one check of the profiler's
    state, no record function entered)."""
    return _record(name) if _profiler_enabled() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of :data:`counters`."""
    counters[name] += n


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
