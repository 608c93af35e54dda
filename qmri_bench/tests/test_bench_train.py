"""The ``train_step`` request kind of ``oai_dess_train.train_step`` on the CPU
at a small size (narrow features, small knees, batches of 3, the reference
in blocks of 2): a run is correct and reads its metrics, each pass over
the pool starts from the same state, the bfloat16 control is not correct,
eight planted faults are not correct, and the work count; on a card, the
TF32 control is not correct either."""

import io

import numpy as np
import pytest
import torch

from qmri_bench import counts, counts_train, counts_unet
from qmri_bench.run import load_cell, run_cell

CELL = "oai_dess_train.train_step"


def _small():
    _, _, cfg, _, _ = load_cell(CELL)
    return {"shape": [48, 48, 6],
            "model": {**cfg["model"], "features": [4, 8, 16]},
            "training": {**cfg["training"], "batch_slices": 3},
            "knee": {**cfg["knee"], "coarse_grid": [4, 4, 3]},
            "labels": {**cfg["labels"], "coarse_grid": [4, 4, 3]},
            "reference_block_slices": 2}


def _run(seed=7, trace=0, **kw):
    return run_cell(CELL, seed, 0.05, trace, torch.device("cpu"), cfg_override=_small(),
                    traffic_override={"pool": 3}, log=io.StringIO(), **kw)


def _limits():
    return load_cell(CELL)[4]


def test_train_run_is_correct_and_reports_its_metrics():
    r = _run(seed=2**31 + 12345)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"fit_mvox_per_s", "setup_s"}
    assert set(r["checks"]) == set(_limits())


def test_traced_run_reads_the_program_spans():
    r = _run(trace=1)
    assert r["correct"]
    # No card: no busy time, so no roofline and no copies; the span readers
    # find their spans, and nothing crosses.
    assert {"fit_mfu", "idle_share.fit", "host_syncs", "h2d_mb", "train_idle_ms",
            "train_place_ms"} <= set(r["metrics"])
    assert r["metrics"]["train_place_ms"]["value"] > 0
    assert r["metrics"]["h2d_mb"]["value"] == 0


@pytest.mark.parametrize("seed", [3, 2**31 + 999])
def test_every_class_covers_its_seeded_share(seed):
    from qmri_bench.requests.train_step import Workload

    _, _, cfg, traffic, _ = load_cell(CELL)
    cfg.update(_small())
    wl = Workload(cfg, {**traffic, "pool": 3}, seed, torch.device("cpu"))
    wl.setup()
    assert sorted(wl.cover.tolist()) == pytest.approx([0.2, 0.4, 0.6, 0.8])
    labels = np.concatenate([y for _, y in wl.batches])
    assert labels.dtype == np.uint8 and labels.shape == (9, 48, 48, 4)
    # 9 of the 12 slices: each class near its share, on both sides of it.
    assert labels.mean(axis=(0, 1, 2)) == pytest.approx(wl.cover.numpy(), abs=0.1)
    images = np.concatenate([x for x, _ in wl.batches])
    assert images.dtype == np.float32 and images.shape == (9, 48, 48, 1)


def test_each_pass_over_the_pool_starts_from_the_origin():
    from qmri_bench.requests.train_step import Workload

    _, _, cfg, traffic, _ = load_cell(CELL)
    cfg.update(_small())
    wl = Workload(cfg, {**traffic, "pool": 3}, 5, torch.device("cpu"))
    wl.setup()
    outs = [wl.request(k, None) for k in range(7)]
    # Every leaf's count: the origin's steps, then one a request, set back
    # every third request.
    n, start = len(wl.names), float(traffic["origin_steps"])
    assert [o.counts for o in outs] == [([start + k % 3] * n, [start + k % 3 + 1] * n)
                                        for k in range(7)]
    for a, b in ((outs[0], outs[3]), (outs[1], outs[4]), (outs[0], outs[6])):
        assert a.batch == b.batch and a.loss == b.loss
        assert all(torch.equal(x, y) for x, y in zip(a.bufs, b.bufs))


def test_bfloat16_control_fails():
    r = _run(control=True)
    assert r["correct"]
    limits = _limits()
    assert any(not r["control"][k] <= lim for k, lim in limits.items()), r["control"]


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card():
    """TF32 exists on the card alone: the reference in float32 with TF32
    allowed has to fail a limit that the program, run beside it, passes.
    The real first widths at 96x96, batches of 4."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 needs a CUDA card")
    import dosma_tpu_torch as dt

    _, _, cfg, _, _ = load_cell(CELL)
    small = {**_small(), "shape": [96, 96, 8],
             "model": {**cfg["model"], "features": [32, 64, 128]},
             "training": {**cfg["training"], "batch_slices": 4}}
    with dt.default_device("cuda"):
        r = run_cell(CELL, 2**31 + 4321, 0.5, 0, torch.device("cuda", 0), cfg_override=small,
                     traffic_override={"pool": 3}, log=io.StringIO(), control=True)
    assert r["correct"], r["checks"]
    failed = [k for k, lim in _limits().items() if not r["control"][k + ".tf32"] <= lim]
    assert failed, r["control"]


def _grads_zeroed(monkeypatch):
    from dosma_tpu_torch.train import seg_trainer

    real = seg_trainer._Step.backward

    def zeroed(self, images, labels):
        loss = real(self, images, labels)
        for p in self.params.values():
            p.grad.zero_()
        return loss

    monkeypatch.setattr(seg_trainer._Step, "backward", zeroed)


def _one_leaf_grad_zeroed(monkeypatch, name="down.1.bn.gamma"):
    from dosma_tpu_torch.train import seg_trainer

    real = seg_trainer._Step.backward

    def zeroed(self, images, labels):
        loss = real(self, images, labels)
        self.params[name].grad.zero_()
        return loss

    monkeypatch.setattr(seg_trainer._Step, "backward", zeroed)


def _step_skipped(monkeypatch):
    from dosma_tpu_torch.train import seg_trainer

    monkeypatch.setattr(seg_trainer._Step, "train_step",
                        lambda self, images, labels: self.backward(images, labels))


def _after_step(monkeypatch, slots):
    """``_Step.train_step`` with the values ``slots(self)`` names put back as
    they were before the step."""
    from dosma_tpu_torch.train import seg_trainer

    real = seg_trainer._Step.train_step

    def forgetful(self, images, labels):
        held = [(t, t.detach().clone()) for t in slots(self)]
        loss = real(self, images, labels)
        with torch.no_grad():
            for t, old in held:
                t.copy_(old)
        return loss

    monkeypatch.setattr(seg_trainer._Step, "train_step", forgetful)


def _one_leaf_frozen(monkeypatch, name="final.bias"):
    _after_step(monkeypatch, lambda step: [step.params[name]])


def _moments_not_stored(monkeypatch):
    _after_step(monkeypatch, lambda step: [
        s[k] for s in step.optimizer.state.values() for k in ("exp_avg", "exp_avg_sq")])


def _count_frozen(monkeypatch):
    _after_step(monkeypatch, lambda step: [s["step"] for s in step.optimizer.state.values()])


def _previous_loss(monkeypatch):
    from dosma_tpu_torch.train import seg_trainer

    real, last = seg_trainer.SegTrainer.step, []

    def stale(self, images, labels):
        loss = real(self, images, labels)
        out = last[-1] if last else loss
        last.append(loss)
        return out

    monkeypatch.setattr(seg_trainer.SegTrainer, "step", stale)


def _half_batch(monkeypatch):
    from dosma_tpu_torch.train import seg_trainer

    real = seg_trainer.SegTrainer.step

    def half(self, images, labels):
        n = max(1, len(images) // 2)
        return real(self, images[:n], labels[:n])

    monkeypatch.setattr(seg_trainer.SegTrainer, "step", half)


# Each fault with the number that has to catch it.
FAULTS = {
    "grads_zeroed": (_grads_zeroed, "grad_rel_gap"),
    "one_leaf_grad_zeroed": (_one_leaf_grad_zeroed, "grad_leaf_gap"),
    "step_skipped": (_step_skipped, "param_off_share"),
    "one_leaf_frozen": (_one_leaf_frozen, "param_leaf_off"),
    "moments_not_stored": (_moments_not_stored, "moment_rel_gap"),
    "count_frozen": (_count_frozen, "count_gap"),
    "previous_loss": (_previous_loss, "loss_rel_gap"),
    "half_batch": (_half_batch, "loss_rel_gap"),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_planted_fault_fails(monkeypatch, name):
    fault, number = FAULTS[name]
    fault(monkeypatch)
    r = _run()
    assert not r["correct"]
    assert r["checks"][number]["value"] > _limits()[number], r["checks"]


def test_work_count():
    features = [32 * 2**d for d in range(6)]
    fwd = counts_unet.slice_flops(384, 384, features, 4)
    # The forward, the weights' gradients, and the inputs' gradients less
    # the first convolution's (1 -> 32 channels at 384x384).
    assert counts_train.train_slice_flops(384, 384, features, 4) == 3 * fwd - 84_934_656
    assert counts_train.train_slice_flops(384, 384, features, 4) == 212_280_016_896
    nbytes, flops = counts_train.train_step_work(32, 384, 384, features, 4)
    assert flops == 32 * 212_280_016_896
    assert nbytes == 4 * 32 * 384 * 384 * 5 + 16 * 34_597_892
    # Bound by the operations: 6.793 TFLOP over 67 TFLOP/s.
    assert counts.least_seconds(nbytes, flops) == pytest.approx(0.101388, rel=1e-5)
