"""The slice as a whole: the port's ``MonoExponentialFit`` and ``T2`` metrics
against the JAX package's on the same volumes.

Both packages get ``MedicalVolume``s built from the same numpy arrays and
affine (``numpy.random.RandomState``). The JAX fit is driven through its
device path (``_fit_device``: polyfit seed + Pallas kernel + post-processing)
in Pallas interpret mode, by patching ``pallas_supported`` to True as
``tests/ops/test_biexp_pallas.py`` does. The port fits CPU volumes with its
plain PyTorch version.

Tolerances:
  - unrounded maps agree to 1e-4 relative: the two fits stop within ~1e-5
    relative of the same optimum (see ``test_torch_monoexp.py``);
  - rounded maps agree to 10**-decimals + 1e-6: a value within that of a
    rounding boundary may round to either side;
  - mask and fill positions, affines and orientation are identical;
  - metric rows: categories and voxel counts identical, Mean / Std / Median
    to 1e-4 relative (the port reduces in float64, numpy in float32, on maps
    that agree to the tolerances above).
"""

import warnings

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

import dosma_tpu
import dosma_tpu_torch
from dosma_tpu.ops import monoexp_pallas
from dosma_tpu_torch.utils.profiling import counters


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_X = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
_SHAPE = (8, 8, 4)
_LABELS = {1: "one", 2: "two"}


def _echoes(seed=0, sigma=0.005):
    rs = np.random.RandomState(seed)
    n = int(np.prod(_SHAPE))
    b = -1 / (rs.rand(n) * 70 + 10)
    Y = np.exp(b[:, None] * _X[None, :]) + sigma * rs.randn(n, _X.size)
    Y = Y.astype(np.float32)
    Y[5] = 0  # an all-zero voxel
    return [Y[:, t].reshape(_SHAPE) for t in range(_X.size)]


def _mask_array():
    m = np.zeros(_SHAPE, np.float32)
    m[:, :, :2] = 1
    m[2:7, 1:6, 2:] = 2
    return m


def _fit_both(monkeypatch, kwargs, with_mask):
    affine = dosma_tpu.to_affine(dosma_tpu.SAGITTAL, spacing=(0.5, 0.5, 2.0), origin=(3, -4, 7))
    arrays = _echoes()
    mask_axial = None
    if with_mask:
        # Hand the mask over in another orientation: both packages must
        # reformat it onto the echoes.
        mask_axial = dosma_tpu.MedicalVolume(_mask_array(), affine).reformat(dosma_tpu.AXIAL)
        mask_axial = (mask_axial.A, mask_axial.affine)

    ys_j = [dosma_tpu.MedicalVolume(a, affine) for a in arrays]
    ys_t = [dosma_tpu_torch.MedicalVolume(a, affine) for a in arrays]
    mask_j = mask_t = None
    if with_mask:
        mask_j = dosma_tpu.MedicalVolume(*mask_axial)
        mask_t = dosma_tpu_torch.MedicalVolume(*mask_axial)

    monkeypatch.setattr(monoexp_pallas, "pallas_supported", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        tc_j, r2_j = dosma_tpu.MonoExponentialFit(**kwargs).fit(_X, ys_j, mask=mask_j)
    launches = counters["monoexp_lm.launches"]
    tc_t, r2_t = dosma_tpu_torch.MonoExponentialFit(**kwargs).fit(_X, ys_t, mask=mask_t)
    assert counters["monoexp_lm.launches"] == launches
    return (tc_j, r2_j, mask_j), (tc_t, r2_t, mask_t)


_CASES = {
    "polyfit_defaults": dict(tc0="polyfit"),
    "tc0_number": dict(tc0=30.0),
    "polyfit_unrounded": dict(tc0="polyfit", decimal_precision=None),
    "tc0_number_unrounded_r2_none": dict(tc0=25.0, decimal_precision=None, r2_threshold=None),
    "bounds_r2_number": dict(tc0="polyfit", bounds=(15.0, 60.0), r2_threshold=0.9),
    "bounds_unrounded": dict(tc0=30.0, bounds=(15.0, 60.0), decimal_precision=None),
}


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", list(_CASES))
def test_fit_matches_jax(monkeypatch, name, with_mask):
    kwargs = _CASES[name]
    (tc_j, r2_j, mask_j), (tc_t, r2_t, _) = _fit_both(monkeypatch, kwargs, with_mask)

    for vj, vt in ((tc_j, tc_t), (r2_j, r2_t)):
        assert isinstance(vt.A, np.ndarray)  # host volumes in, host maps out
        np.testing.assert_array_equal(vt.affine, vj.affine)
        assert vt.orientation == vj.orientation
        assert vt.shape == vj.shape

    a_j, a_t = np.asarray(tc_j.A), tc_t.A
    np.testing.assert_array_equal(a_t == 0, a_j == 0)  # fill positions
    decimals = kwargs.get("decimal_precision", 1)
    if decimals is None:
        np.testing.assert_allclose(a_t, a_j, rtol=1e-4, atol=0)
    else:
        assert np.abs(a_t - a_j).max() <= 10.0 ** -decimals + 1e-6
    np.testing.assert_allclose(r2_t.A, np.asarray(r2_j.A), rtol=0, atol=1e-4)
    assert (a_t > 0).sum() > 0.3 * a_t.size  # the case fits real voxels

    if with_mask:
        outside = np.asarray(mask_j.reformat_as(tc_j).A) == 0
        assert (a_t[outside] == 0).all()

    # The map's regional metrics, row by row.
    df_j = dosma_tpu.T2(tc_j).to_metrics(mask_j, _LABELS if with_mask else None)
    df_t = dosma_tpu_torch.T2(tc_t).to_metrics(
        None if not with_mask else dosma_tpu_torch.MedicalVolume(mask_j.A, mask_j.affine),
        _LABELS if with_mask else None,
    )
    assert list(df_t.columns) == list(df_j.columns)
    assert list(df_t["Category"]) == list(df_j["Category"])
    assert list(df_t["# Voxels"]) == list(df_j["# Voxels"])
    for col in ("Mean", "Std", "Median"):
        np.testing.assert_allclose(
            df_t[col].to_numpy(float), df_j[col].to_numpy(float), rtol=1e-4, atol=1e-6
        )


def test_metrics_bounds_and_default_labels_match_jax():
    rs = np.random.RandomState(11)
    affine = dosma_tpu.to_affine(dosma_tpu.CORONAL, spacing=(1.0, 0.7, 0.7))
    vol = (rs.rand(*_SHAPE) * 80).astype(np.float32)
    vol[0, 0, 0] = np.nan
    mask = _mask_array()
    for bounds, closed in ((None, "right"), ((10.0, 50.0), "both"), ((10.0, 50.0), "neither")):
        df_j = dosma_tpu.T2(dosma_tpu.MedicalVolume(vol, affine)).to_metrics(
            dosma_tpu.MedicalVolume(mask, affine), bounds=bounds, closed=closed
        )
        rows_t = dosma_tpu_torch.T2(dosma_tpu_torch.MedicalVolume(vol, affine)).metric_rows(
            dosma_tpu_torch.MedicalVolume(mask, affine), bounds=bounds, closed=closed
        )
        assert [r["Category"] for r in rows_t] == list(df_j["Category"])
        assert [r["# Voxels"] for r in rows_t] == list(df_j["# Voxels"])
        for col in ("Mean", "Std", "Median"):
            np.testing.assert_allclose(
                [r[col] for r in rows_t], df_j[col].to_numpy(float), rtol=1e-5
            )


def test_tensor_volumes_give_tensor_maps():
    affine = dosma_tpu_torch.to_affine(dosma_tpu_torch.AXIAL)
    ys = [dosma_tpu_torch.MedicalVolume(torch.from_numpy(a), affine) for a in _echoes(seed=2)]
    tc, r2 = dosma_tpu_torch.MonoExponentialFit(tc0="polyfit").fit(_X, ys)
    assert isinstance(tc.A, torch.Tensor) and tc.A.device.type == "cpu"
    assert tc.shape == _SHAPE and torch.isfinite(tc.A).all()

    ys_np = [dosma_tpu_torch.MedicalVolume(a, affine) for a in _echoes(seed=2)]
    tc_np, _ = dosma_tpu_torch.MonoExponentialFit(tc0="polyfit").fit(_X, ys_np)
    np.testing.assert_array_equal(tc.A.numpy(), tc_np.A)


def test_constructor_validation():
    with pytest.raises(ValueError):
        dosma_tpu_torch.MonoExponentialFit(tc0="guess")
    with pytest.raises(ValueError):
        dosma_tpu_torch.MonoExponentialFit(bounds=(1, 2, 3))
    with pytest.raises(ValueError):
        dosma_tpu_torch.MonoExponentialFit(r2_threshold="sometimes")
    affine = dosma_tpu_torch.to_affine(dosma_tpu_torch.AXIAL)
    ys = [dosma_tpu_torch.MedicalVolume(a, affine) for a in _echoes()]
    with pytest.raises(ValueError):
        dosma_tpu_torch.MonoExponentialFit().fit(_X[:3], ys)
    bad_mask = dosma_tpu_torch.MedicalVolume(np.ones((8, 8, 3)), affine)
    with pytest.raises(RuntimeError):
        dosma_tpu_torch.MonoExponentialFit().fit(_X, ys, mask=bad_mask)


@pytest.mark.parametrize(
    "option", [{"num_workers": 2}, {"chunksize": 10}, {"verbose": True}],
)
def test_unported_host_options_warn(option):
    # Only dosma_tpu's host fit path reads these; the port has none, so a
    # caller who sets one is told, not silently ignored.
    with pytest.warns(UserWarning, match=next(iter(option))):
        dosma_tpu_torch.MonoExponentialFit(**option)


def test_default_host_options_do_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dosma_tpu_torch.MonoExponentialFit(num_workers=0, chunksize=1000, verbose=False)


def test_host_data_without_a_card_or_a_cpu_request_raises(monkeypatch):
    # Entry points compute host data on the default device, the first CUDA
    # card; with none and no request for the CPU they raise, never fall back.
    from dosma_tpu_torch.core import device

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: host data is fit there")
    monkeypatch.setattr(device, "_default_device", None)
    affine = dosma_tpu_torch.to_affine(dosma_tpu_torch.SAGITTAL, spacing=(0.5, 0.5, 2.0))
    ys = [dosma_tpu_torch.MedicalVolume(a, affine) for a in _echoes()]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dosma_tpu_torch.MonoExponentialFit(tc0="polyfit").fit(_X, ys)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dosma_tpu_torch.curve_fit(dosma_tpu_torch.monoexponential, _X, np.ones((4, 3), np.float32))
    with device.default_device("cpu"):
        tc, _ = dosma_tpu_torch.MonoExponentialFit(tc0="polyfit").fit(_X, ys)
    assert isinstance(tc.A, np.ndarray) and tc.shape == _SHAPE
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dosma_tpu_torch.T2(tc).metric_rows()
