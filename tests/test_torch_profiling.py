"""The port's profiling utilities (``dosma_tpu_torch/utils/profiling.py``)
against ``dosma_tpu``'s: ``StageTimer``'s report is the JAX package's for
the same times; ``trace`` writes a Chrome trace with the annotated regions,
nested as they were entered."""

import json
import logging

import numpy as np
import pytest
import torch

import dosma_tpu_torch as dt
from dosma_tpu.utils import profiling as jprof
from dosma_tpu_torch.utils import profiling as tprof


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    with dt.default_device("cpu"):
        yield


@pytest.mark.parametrize("times", [{}, {"load": 1.5}, {"read": 0.25, "fit": 12.3456789,
                                                       "metrics and rows": 0.0004}])
def test_stage_timer_report_equals_jax(times):
    t, j = tprof.StageTimer(), jprof.StageTimer()
    t.times, j.times = dict(times), dict(times)
    assert t.report() == j.report()


def test_stage_timer_accumulates_and_logs(caplog):
    timer = tprof.StageTimer(verbose=True)
    with caplog.at_level(logging.INFO, logger=tprof.__name__):
        for _ in range(2):
            with timer("fit"):
                pass
        with pytest.raises(ValueError):
            with timer("load"):
                raise ValueError("timed all the same")
    assert list(timer.times) == ["fit", "load"] and all(v >= 0 for v in timer.times.values())
    assert sum("[fit]" in r.message for r in caplog.records) == 2
    assert timer.report().splitlines()[-1].startswith("total")


def test_trace_writes_nested_annotations(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as prof:
        with tprof.annotate("outer"):
            with tprof.annotate("inner"):
                torch.ones(64).cumsum(0)
    files = list((tmp_path / "trace").iterdir())
    assert [f.name for f in files] == [prof.trace_path.split("/")[-1]]
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer", "inner")
             and e.get("ph") == "X"}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_trace_of_a_sharded_fit_shows_the_plain_version_on_the_cpu(tmp_path):
    """On the CPU the fit takes monoexp_lm's plain version: its operations
    are in the trace (on a card the kernel is, ``chip_smoke.py`` phase 14)."""
    from dosma_tpu_torch.parallel.sharding import sharded_lm_fit

    x = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
    Y = np.exp(-np.outer(np.linspace(0.02, 0.05, 64), x)).astype(np.float32)
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("sharded_fit"):
            sharded_lm_fit(dt.monoexponential, x, Y, np.array([1.0, -0.03]), max_iter=20)
    names = {e.get("name") for e in json.loads(open(prof.trace_path).read())["traceEvents"]}
    assert "sharded_fit" in names and "aten::exp" in names
