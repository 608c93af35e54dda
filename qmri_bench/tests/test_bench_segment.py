"""The ``segment`` request kind of ``oai_dess.segment`` on the CPU at a small
size (narrow features, a small knee, two batches a knee, the second short):
a run is correct, every class covers its seeded share of the knee, the
bfloat16 control and planted faults are not correct, and the work count."""

import io

import numpy as np
import pytest
import torch

from qmri_bench import counts, counts_unet
from qmri_bench.run import load_cell, run_cell

CELL = "oai_dess.segment"


def _small():
    _, _, cfg, _, _ = load_cell(CELL)
    return {"shape": [48, 48, 6],
            "model": {**cfg["model"], "features": [4, 8, 16, 32], "batch_size": 4},
            "knee": {**cfg["knee"], "coarse_grid": [4, 4, 3]}}


def _run(seed=7, trace=0, **kw):
    return run_cell(CELL, seed, 0.05, trace, torch.device("cpu"), cfg_override=_small(),
                    log=io.StringIO(), **kw)


def _limit():
    return load_cell(CELL)[4]["mask_off_share"]


def test_segment_run_is_correct_and_reports_its_metrics():
    r = _run(seed=2**31 + 12345)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"fit_mvox_per_s", "setup_s"}
    assert r["checks"]["mask_off_share"]["value"] <= _limit()


def test_traced_run_reads_the_program_spans():
    r = _run(trace=1)
    assert r["correct"]
    # No card: no busy time, so no roofline and no copies; the span readers
    # find their spans.
    assert {"fit_mfu", "idle_share.fit", "segment_idle_ms", "unpack_ms"} <= set(r["metrics"])
    assert r["metrics"]["unpack_ms"]["value"] > 0


@pytest.mark.parametrize("seed", [3, 2**31 + 999])
def test_every_class_covers_its_seeded_share(seed):
    """The head's biases put each class on both sides of the threshold, near
    its drawn share, and the shares are a seeded order of 20-80%."""
    from qmri_bench.requests.segment import Workload

    _, _, cfg, traffic, _ = load_cell(CELL)
    cfg.update(_small())
    wl = Workload(cfg, traffic, seed, torch.device("cpu"))
    wl.setup()
    cover = wl.cover.numpy()
    assert sorted(np.round(cover, 1)) == pytest.approx([0.2, 0.4, 0.6, 0.8], abs=0.1)
    answers = [wl.request(k, None)[1] for k in range(len(wl.knees))]
    got = np.array([np.mean([a[c].mean() for a in answers]) for c in wl.classes])
    # The biases come from 8 slices of each knee of the pool; a knee has 6
    # here, so over the pool the share differs only by the quantile's
    # interpolation.
    assert got == pytest.approx(cover, abs=1e-3)


def test_bfloat16_control_fails():
    r = _run(control=True)
    assert r["correct"]
    assert r["control"]["mask_off_share"] > _limit(), r["control"]


def _bn_skipped(monkeypatch):
    from dosma_tpu_torch.models import unet2d

    monkeypatch.setattr(unet2d._BatchNorm, "forward", lambda self, x: x)


def _classes_swapped(monkeypatch):
    from dosma_tpu_torch.models import oaiunet2d

    monkeypatch.setattr(oaiunet2d.IWOAIOAIUnet2D, "CATEGORIES", ["fc", "tc", "men", "pc"])


def _first_batch_zeroed(monkeypatch):
    from dosma_tpu_torch.models import unet2d

    real = unet2d._run_batches

    def zeroed(net, slices, mean, std, threshold, dtype, bits_per_px, batch_size):
        out = real(net, slices, mean, std, threshold, dtype, bits_per_px, batch_size)
        out[:batch_size] = 0
        return out

    monkeypatch.setattr(unet2d, "_run_batches", zeroed)


@pytest.mark.parametrize("fault", [_bn_skipped, _classes_swapped, _first_batch_zeroed],
                         ids=["bn_skipped", "classes_swapped", "first_batch_zeroed"])
def test_planted_fault_fails(monkeypatch, fault):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["mask_off_share"]["value"] > _limit()


def test_work_count():
    features = [32 * 2**d for d in range(6)]
    # 70.8 GFLOP a 384x384 slice; a 288x288 slice takes the stride-3 path.
    assert counts_unet.slice_flops(384, 384, features, 4) == 70_788_317_184
    assert counts_unet.slice_flops(288, 288, features, 4) == 39_818_428_416
    assert counts_unet.slice_flops(384, 384, features, 1) == 70_760_005_632
    assert counts_unet.parameter_count(features, 4) == 34_597_892
    nbytes, flops = counts_unet.segment_work((384, 384, 160), features, 4)
    assert flops == 160 * 70_788_317_184
    assert nbytes == 4 * 384 * 384 * 160 + 4 * 34_597_892 + 384 * 384 * 160 // 2
    # Bound by the operations: 11.33 TFLOP over 67 TFLOP/s.
    assert counts.least_seconds(nbytes, flops) == pytest.approx(0.16905, rel=1e-4)
