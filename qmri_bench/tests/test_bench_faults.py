"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, everything else as in a run. Faults a
cell can have: a step that returns its state unchanged, half of the batch
left out with the mean taken over the rest, an answer altered where it is
produced. (No cell exchanges data between cards.)"""

import pytest

from qmri_bench import faults
from qmri_bench.tests.conftest import small_run

FITS = ["t2_config1.card_fit", "t2_config1.host_fit", "cubequant_t1rho.t1rho_fit"]


def _fit_unchanged(monkeypatch):
    from dosma_tpu_torch.ops import monoexp_pipeline

    real = monoexp_pipeline.monoexp_lm
    monkeypatch.setattr(monoexp_pipeline, "monoexp_lm",
                        lambda *a, **k: real(*a, **{**k, "max_iter": 0}))


def _half_batch(monkeypatch):
    from dosma_tpu_torch.core import quant_vals
    from dosma_tpu_torch.ops import analytics

    real = analytics.summary
    monkeypatch.setattr(analytics, "summary", lambda v, fns=None: real(v[: v.numel() // 2], fns))
    assert quant_vals  # metric_rows imports summary from analytics at each call


def _rows_altered(monkeypatch):
    from dosma_tpu_torch.ops import analytics

    real = analytics.summary

    def altered(v, fns=None):
        row = real(v, fns)
        row["Mean"] = row["Mean"] * (1 + 1e-6)
        return row

    monkeypatch.setattr(analytics, "summary", altered)


def _map_altered(monkeypatch):
    from dosma_tpu_torch.ops import monoexp_pipeline

    real = monoexp_pipeline.monoexp_lm

    def altered(*a, **k):
        popt, r2, conv = real(*a, **k)
        popt = popt.clone()
        popt[::50, 1] *= 1.01  # every 50th voxel's rate 1% off
        return popt, r2, conv

    monkeypatch.setattr(monoexp_pipeline, "monoexp_lm", altered)


@pytest.mark.parametrize("fault", [_fit_unchanged, _half_batch, _rows_altered, _map_altered])
@pytest.mark.parametrize("cell", FITS)
def test_fit_faults(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = small_run(cell)
    assert r["correct"] is False, r["checks"]
    assert r["failed"] == 0


def _adam_unchanged(monkeypatch):
    faults.adam_unchanged(monkeypatch.setattr)


def _warp_altered(monkeypatch):
    from dosma_tpu_torch.ops import warp

    real = warp.warp_grid_reference

    def altered(srcs, B, out_shape, order):
        out = real(srcs, B, out_shape, order).clone()
        out.view(-1)[out.numel() // 2] += 10.0
        return out

    monkeypatch.setattr(warp, "warp_grid_reference", altered)


def _half_pair(monkeypatch):
    """Half of the volume's voxels left out of the answer: the lower half of
    the resampled volume zeroed."""
    from dosma_tpu_torch.ops import warp

    real = warp.warp_grid_reference

    def half(srcs, B, out_shape, order):
        out = real(srcs, B, out_shape, order).clone()
        out[..., : out.shape[-3] // 2, :, :] = 0.0
        return out

    monkeypatch.setattr(warp, "warp_grid_reference", half)


@pytest.mark.parametrize("fault", [_adam_unchanged, _warp_altered, _half_pair])
def test_registration_faults(fault, monkeypatch):
    fault(monkeypatch)
    r = small_run("cubequant_t1rho.register_pair")
    assert r["correct"] is False, r["checks"]
    assert all(c["value"] < float("inf") for c in r["checks"].values())


@pytest.mark.parametrize("name", sorted(faults.REGISTRATION))
def test_planted_fault_is_undone(name):
    from dosma_tpu_torch.ops import registration

    before = {k: getattr(registration, k) for k in ("_adam_step", "_stage_sigmas", "_cosine_lrs")}
    with faults.planted(faults.REGISTRATION[name]):
        assert any(getattr(registration, k) is not v for k, v in before.items())
    assert all(getattr(registration, k) is v for k, v in before.items())
