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


# ---------------------------------------------------------------- the spans
def _spans(trace_path, prefix="dosma."):
    """(name, start, end, category) of the trace's complete events named
    ``prefix...``."""
    events = json.loads(open(trace_path).read())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("cat")) for e in events
            if e.get("ph") == "X" and str(e.get("name")).startswith(prefix)]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_annotate_enters_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a record function was entered for {name}")

    monkeypatch.setattr(tprof, "_record", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tprof.annotate("dosma.fit"):
        with tprof.annotate("dosma.fit.lm"):
            torch.ones(4).sum()
    assert tprof.annotate("a") is tprof.annotate("b")  # one shared no-op context


def _echoes(shape=(6, 5, 4)):
    x = [10.0, 20.0, 30.0, 40.0]
    tc = np.random.RandomState(0).uniform(20, 60, shape).astype(np.float32)
    ys = [dt.MedicalVolume(np.exp(-t / tc).astype(np.float32), np.eye(4)) for t in x]
    mask = dt.MedicalVolume((tc > 30).astype(np.uint8), np.eye(4))
    return x, ys, mask


@pytest.mark.parametrize("masked", [False, True])
def test_fit_stages_nest_in_the_fit_span(tmp_path, masked):
    x, ys, mask = _echoes()
    with tprof.trace(str(tmp_path)) as prof:
        dt.MonoExponentialFit(tc0="polyfit").fit(x, ys, mask=mask if masked else None)
    spans = _spans(prof.trace_path)
    (fit,) = [s for s in spans if s[0] == "dosma.fit"]
    stages = {s[0]: s for s in spans if s[0] != "dosma.fit"}
    assert set(stages) == {f"dosma.fit.{k}" for k in ("prepare", "stack", "lm", "post", "maps")}
    assert all(_inside(s, fit) for s in stages.values())
    # CPU events of the profiler, not user annotations: the card gets no copy.
    assert {s[3] for s in spans} == {"cpu_op"}


def test_scan_map_span_holds_the_fit(tmp_path):
    x, ys, _ = _echoes()
    with tprof.trace(str(tmp_path)) as prof:
        dt.CubeQuant(ys, spin_lock_times=x).generate_t1_rho_map()
    spans = _spans(prof.trace_path, "dosma.fit")
    (scan,) = [s for s in spans if s[0] == "dosma.fit.scan"]
    (fit,) = [s for s in spans if s[0] == "dosma.fit"]
    assert _inside(fit, scan)


def test_metric_rows_stages_nest_in_the_rows_span(tmp_path):
    x, ys, mask = _echoes()
    tc, _ = dt.MonoExponentialFit(tc0="polyfit").fit(x, ys)
    with tprof.trace(str(tmp_path)) as prof:
        rows = dt.T2(tc).metric_rows(mask, {1: "inside"})
    assert [r["Category"] for r in rows] == ["inside", "total"]
    spans = _spans(prof.trace_path)
    (whole,) = [s for s in spans if s[0] == "dosma.rows"]
    stages = [s for s in spans if s[0] != "dosma.rows"]
    assert sorted(s[0] for s in stages) == ["dosma.rows.gather", "dosma.rows.summary"]
    assert all(_inside(s, whole) for s in stages)


def test_registration_spans_a_level_each_and_counts_adam_iterations(tmp_path):
    from dosma_tpu_torch.ops import registration as treg

    shape = (12, 12, 8)
    fixed = np.zeros(shape, np.float32)
    fixed[3:9, 4:10, 2:6] = 1.0
    moving = np.roll(fixed, 1, axis=0)
    params = treg.RegistrationParams(transform="translation", metric="mse", resolutions=2,
                                     iterations=3, num_samples=64)
    before = tprof.counters["adam.iterations"]
    with tprof.trace(str(tmp_path)) as prof:
        treg.register_chain(fixed, np.eye(4), moving, np.eye(4), [params])
    assert tprof.counters["adam.iterations"] - before == 2 * 3
    spans = _spans(prof.trace_path, "dosma.register")
    levels = [s for s in spans if s[0] == "dosma.register.level"]
    assert len(levels) == 2
    for name in ("dosma.register.prep", "dosma.register.adam"):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == 2 and all(any(_inside(s, lv) for lv in levels) for s in inner)
    (warp,) = [s for s in spans if s[0] == "dosma.register.warp"]
    assert not any(_inside(warp, lv) for lv in levels)


def test_h2d_bytes_count_host_to_device_copies_only():
    from dosma_tpu_torch.core.device import as_tensor

    before = tprof.counters["h2d.bytes"]
    as_tensor(np.ones((3, 5), np.float32), "cpu")  # host to host
    as_tensor(torch.ones(7, dtype=torch.float64), torch.device("cpu"))
    assert tprof.counters["h2d.bytes"] == before
    out = as_tensor(np.ones((3, 5), np.uint16), "meta")  # the meta device stands in for a card
    assert out.device.type == "meta" and out.dtype == torch.int32
    assert tprof.counters["h2d.bytes"] == before + 3 * 5 * 2  # the narrow bytes cross
    as_tensor(torch.ones(7, dtype=torch.float64), torch.device("meta"))
    assert tprof.counters["h2d.bytes"] == before + 30 + 56
    as_tensor(out, "meta")  # already on the device
    assert tprof.counters["h2d.bytes"] == before + 30 + 56


def test_count_adds_to_the_registry():
    before = tprof.counters["test.count"]
    tprof.count("test.count")
    tprof.count("test.count", 4)
    assert tprof.counters["test.count"] == before + 5


SEGMENT_STAGES = {f"dosma.segment.{k}" for k in ("stage", "forward", "copy", "unpack", "masks")}


def _segmenter(name, shape=(32, 32, 6)):
    """Model ``name`` on narrow seeded weights, and a sagittal volume."""
    from dosma_tpu_torch.models import unet2d

    model = getattr(dt.models, name)(shape[:2] + (1,), None, force_weights=True)
    classes = len(getattr(model, "CATEGORIES", [None]))
    model.seg_model.params = unet2d.init_unet2d_params(
        torch.Generator().manual_seed(0), num_classes=classes, features=[4, 8, 16])
    model.batch_size = 4  # two batches, the second short
    arr = (np.random.RandomState(1).rand(*shape) * 1000).astype(np.uint16)
    return model, dt.MedicalVolume(arr, dt.to_affine(dt.SAGITTAL, (0.3, 0.3, 0.7))), classes


@pytest.mark.parametrize("name", ["IWOAIOAIUnet2DNormalized", "OAIUnet2D",
                                  "StanfordQDessUNet2D"])
def test_generate_mask_stages_nest_in_the_segment_span_and_count(tmp_path, name):
    model, vol, classes = _segmenter(name)
    before = dict(tprof.counters)
    with tprof.trace(str(tmp_path)) as prof:
        model.generate_mask(vol)
    spans = _spans(prof.trace_path, "dosma.segment")
    (whole,) = [s for s in spans if s[0] == "dosma.segment"]
    stages = [s for s in spans if s[0] != "dosma.segment"]
    assert {s[0] for s in stages} == SEGMENT_STAGES
    assert all(_inside(s, whole) for s in stages)
    # Staging and reformat, then the whitening statistics beside the network.
    assert sorted(s[0] for s in stages).count("dosma.segment.stage") == 2
    assert {s[3] for s in spans} == {"cpu_op"}
    bits = {1: 1, 4: 4}[classes]
    assert tprof.counters["segment.slices"] - before.get("segment.slices", 0) == 6
    assert (tprof.counters["segment.mask_bytes"] - before.get("segment.mask_bytes", 0)
            == 6 * 32 * 32 * bits // 8)


def test_generate_mask_enters_no_span_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a record function was entered for {name}")

    model, vol, _ = _segmenter("IWOAIOAIUnet2DNormalized")
    monkeypatch.setattr(tprof, "_record", refuse)
    before = tprof.counters["segment.slices"]
    masks = model.generate_mask(vol)
    assert list(masks) == ["fc", "tc", "pc", "men"]
    assert tprof.counters["segment.slices"] == before + 6  # counters are always on


TRAIN_STAGES = [f"dosma.train.{k}" for k in ("place", "forward", "backward", "optimizer", "loss")]


def test_train_step_stages_nest_in_the_train_span_and_count(tmp_path):
    """``SegTrainer.step`` records ``dosma.train`` and its five stages in
    order; on the CPU nothing crosses, so ``h2d.bytes`` stays as it was."""
    from dosma_tpu_torch.models.unet2d import init_unet2d_params
    from dosma_tpu_torch.train import SegTrainer

    params = init_unet2d_params(torch.Generator().manual_seed(0), num_classes=2,
                                features=[4, 8, 16])
    trainer = SegTrainer(num_classes=2, features=[4, 8, 16], params=params)
    rs = np.random.RandomState(0)
    images = rs.rand(3, 16, 16, 1).astype(np.float32)
    labels = (rs.rand(3, 16, 16, 2) > 0.5).astype(np.uint8)
    before = dict(tprof.counters)
    with tprof.trace(str(tmp_path)) as prof:
        loss = trainer.step(images, labels)
    assert np.isfinite(loss)
    spans = _spans(prof.trace_path, "dosma.train")
    (whole,) = [s for s in spans if s[0] == "dosma.train"]
    stages = sorted((s for s in spans if s[0] != "dosma.train"), key=lambda s: s[1])
    assert [s[0] for s in stages] == TRAIN_STAGES
    assert all(_inside(s, whole) for s in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))  # one after another
    assert {s[3] for s in spans} == {"cpu_op"}
    assert tprof.counters["h2d.bytes"] == before.get("h2d.bytes", 0)
