"""The reduction of the program's spans (``program_trace.py``) on synthetic
events, and the accepted reduction (``tracing.py``) beside them."""

import torch

from qmri_bench import tracing
from qmri_bench.program_trace import OUTSIDE, reduce_program

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    """What the reductions read of a profiler event; times in ns."""

    def __init__(self, name, start, end, device=CPU):
        self._name, self._start, self._dur, self._device = name, start, end - start, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._device


def _request():
    """One request, 0..1000 ns: dosma.fit (100..600) holding dosma.fit.lm
    (200..400), dosma.rows (650..950); kernels at 250..350 and 700..800, a
    copy at 500..550; syncs at 300 (in lm), 520 (in fit), 900 (in rows) and
    980 (outside)."""
    return [
        Event(tracing.REQUEST, 0, 1000),
        Event("dosma.fit", 100, 600),
        Event("dosma.fit.lm", 200, 400),
        Event("dosma.rows", 650, 950),
        Event("aten::mul", 250, 260),
        Event("fit_kernel", 250, 350, CUDA),
        Event("rows_kernel", 700, 800, CUDA),
        Event("Memcpy HtoD (Pageable -> Device)", 500, 550, CUDA),
        Event("cudaLaunchKernel", 240, 245),
        Event("cudaStreamSynchronize", 300, 350),
        Event("cudaStreamSynchronize", 520, 550),
        Event("cudaDeviceSynchronize", 900, 905),
        Event("cudaEventSynchronize", 980, 990),
    ]


def test_idle_goes_to_the_innermost_span_and_the_rest_outside():
    prog = reduce_program(_request(), 1, {"h2d.bytes": 64})
    idle = {k: round(v * 1e9) for k, v in prog["idle_s"].items()}
    # lm 200..400 less the kernel 250..350; fit 100..200 and 400..600 less the copy.
    assert idle == {"dosma.fit.lm": 100, "dosma.fit": 250, "dosma.rows": 200, OUTSIDE: 200}
    assert round(prog["idle_total_s"] * 1e9) == sum(idle.values()) == 750
    assert prog["spans"]["dosma.fit"]["count"] == 1
    assert round(prog["spans"]["dosma.fit"]["host_s"] * 1e9) == 500
    assert round(prog["spans"]["dosma.fit"]["self_s"] * 1e9) == 300  # less its child
    assert prog["counters"] == {"h2d.bytes": 64} and prog["requests"] == 1


def test_syncs_are_counted_per_innermost_span():
    prog = reduce_program(_request(), 1)
    assert prog["syncs"] == {"dosma.fit.lm": 1, "dosma.fit": 1, "dosma.rows": 1, OUTSIDE: 1}


def test_idle_of_every_gap_in_many_requests():
    events = []
    for r in range(50):
        events += [Event(e.name(), e.start_ns() + 1000 * r, e.start_ns() + e.duration_ns()
                         + 1000 * r, e.device_type()) for e in _request()]
    prog = reduce_program(events, 50)
    assert round(prog["idle_s"]["dosma.fit"] * 1e9) == 50 * 250
    assert round(prog["idle_total_s"] * 1e9) == 50 * 750
    assert prog["spans"]["dosma.rows"]["count"] == 50


def test_card_copies_of_program_spans_are_no_device_work():
    """A ``dosma.*`` span on the card's timeline (a user annotation's copy)
    is left out of the program's idle, and the program's CPU spans leave the
    accepted reduction as it is without them."""
    base = _request()
    copies = [Event("dosma.fit", 240, 560, CUDA), Event("dosma.rows", 700, 800, CUDA)]
    assert reduce_program(base + copies, 1)["idle_s"] == reduce_program(base, 1)["idle_s"]
    without = [e for e in base if not e.name().startswith("dosma.")]
    got, want = tracing._reduce(base, 1), tracing._reduce(without, 1)
    for key in ("busy_s", "kernels", "copies", "device_ops", "launches", "device_events"):
        assert got[key] == want[key], key


def test_no_request_no_reduction():
    assert reduce_program([Event("dosma.fit", 0, 10)], 1) is None


def test_a_card_busy_through_the_window_leaves_no_idle():
    events = [Event(tracing.REQUEST, 0, 100), Event("dosma.fit", 0, 100),
              Event("kernel", 0, 100, CUDA)]
    prog = reduce_program(events, 1)
    assert prog["idle_total_s"] == 0 and prog["idle_s"]["dosma.fit"] == 0


def test_a_program_without_counters_gives_nothing(monkeypatch):
    from dosma_tpu_torch.utils import profiling
    from qmri_bench import program_trace

    monkeypatch.delattr(profiling, "counters")
    ctx = {"trace": {"requests": 1}}
    assert program_trace.program_trace(ctx) is None and ctx["program_trace"] is None


def test_a_traced_run_reports_the_program_metrics():
    import io

    from qmri_bench.run import run_cell
    from qmri_bench.tests.conftest import SMALL

    result = run_cell("t2_config1.host_fit", 7, 0.05, 1, torch.device("cpu"),
                      cfg_override=SMALL["t2_config1"], log=io.StringIO())
    metrics = result["metrics"]
    assert result["correct"]
    assert {"fit_idle_ms", "rows_idle_ms", "host_syncs", "h2d_mb"} <= set(metrics)
    assert metrics["fit_idle_ms"]["value"] > 0 and metrics["rows_idle_ms"]["value"] > 0
    # On the CPU nothing crosses to a card and no host waits on one.
    assert metrics["h2d_mb"]["value"] == 0 and metrics["host_syncs"]["value"] == 0
