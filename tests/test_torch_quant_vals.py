"""The port's ``QuantitativeValue`` against the JAX package's.

``to_metrics`` with and without a mask, with bounds and with ``fns``, on a
host map and on a tensor-backed map (a CPU tensor takes the same gather and
float64 reductions as a card's): the DataFrames must equal ``dosma_tpu``'s
(numpy's float32 reductions), categories and voxel counts exactly and
Mean / Std / Median / fns to rtol 1e-6. Masks of every integer type, uint16 and uint32 included (torch
has no CPU comparison for those: the port widens them). Maps and their
companion volumes save as NIfTI and load back in either package.
"""

import warnings

import numpy as np
import pytest
import torch

import dosma_tpu
import dosma_tpu_torch as dt
from dosma_tpu.core import quant_vals as jqv
from dosma_tpu_torch.core import quant_vals as tqv


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_AFFINE = dosma_tpu.to_affine(dosma_tpu.SAGITTAL, spacing=(0.5, 0.5, 2.0), origin=(3, -4, 7))


def _map(seed=11, special=True):
    rs = np.random.RandomState(seed)
    arr = (rs.rand(16, 16, 6) * 80).astype(np.float32)
    if special:
        arr[0, 0, 0] = np.nan
        arr[1, 1, 1] = 150.0  # outside (0, 100]
        arr[2, 2, 2] = np.inf
        arr[3, 3, 3] = 100.0  # on the upper bound
        arr[4, 4, 4] = 0.0  # on the lower bound
    return arr


def _mask(dtype=np.int32):
    m = np.zeros((16, 16, 6), dtype)
    m[:8] = 1
    m[8:, :8] = 2
    m[12:, 12:, :2] = 5
    return m


def _assert_frames_equal(got, ref, extra=()):
    assert list(got.columns) == list(ref.columns)
    assert list(got["Category"]) == list(ref["Category"])
    assert list(got["# Voxels"]) == list(ref["# Voxels"])
    for col in ("Mean", "Std", "Median", *extra):
        np.testing.assert_allclose(got[col].to_numpy(float), ref[col].to_numpy(float),
                                   rtol=1e-6, atol=0, equal_nan=True)


def _port_map(arr, backing):
    return dt.MedicalVolume(torch.from_numpy(arr.copy()) if backing == "tensor" else arr.copy(),
                            _AFFINE)


_FNS = {"Max": lambda v: float(np.max(v)) if v.size else np.nan,
        "P90": lambda v: float(np.percentile(v, 90)) if v.size else np.nan}


# name: (mask given, bounds, closed, fns, labels)
_CASES = {
    "no_mask": (False, None, "right", None, None),
    "no_mask_bounds": (False, (0, 100), "right", None, None),
    "no_mask_fns": (False, (0, 100), "both", _FNS, None),
    "mask": (True, None, "right", None, None),
    "mask_bounds_right": (True, (0, 100), "right", None, None),
    "mask_bounds_left": (True, (0, 100), "left", None, None),
    "mask_bounds_both": (True, (0, 100), "both", None, None),
    "mask_bounds_neither": (True, (0, 100), "neither", None, None),
    "mask_fns": (True, (0, 100), "right", _FNS, None),
    "mask_labels": (True, None, "right", None, {1: "femoral", 2: "tibial", 7: "absent"}),
}


@pytest.mark.parametrize("backing", ["numpy", "tensor"])
@pytest.mark.parametrize("name", list(_CASES))
def test_to_metrics_matches_jax(name, backing):
    with_mask, bounds, closed, fns, labels = _CASES[name]
    arr = _map()
    mask_t = mask_j = None
    if with_mask:
        # in another orientation: both packages reformat it onto the map
        mj = dosma_tpu.MedicalVolume(_mask(), _AFFINE).reformat(dosma_tpu.AXIAL)
        mask_j = mj
        mask_t = dt.MedicalVolume(np.asarray(mj.A).copy(), mj.affine)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = jqv.T2(dosma_tpu.MedicalVolume(arr, _AFFINE)).to_metrics(
            mask_j, labels=labels, bounds=bounds, closed=closed, fns=fns)
    got = tqv.T2(_port_map(arr, backing)).to_metrics(mask_t, labels=labels, bounds=bounds,
                                                     closed=closed, fns=fns)
    _assert_frames_equal(got, ref, extra=tuple(fns or ()))


@pytest.mark.parametrize("mask_dtype", [np.uint8, np.uint16, np.uint32, np.int16, np.int64,
                                        np.float32, bool])
@pytest.mark.parametrize("backing", ["numpy", "tensor"])
def test_mask_dtypes(mask_dtype, backing):
    """uint16 and uint32 masks raised before the port widened them."""
    arr = _map(seed=3)
    mask = (_mask() > 0) if mask_dtype is bool else _mask(mask_dtype)
    ref = jqv.T2(dosma_tpu.MedicalVolume(arr, _AFFINE)).to_metrics(
        dosma_tpu.MedicalVolume(mask, _AFFINE), bounds=(0, 100))
    for mask_backing in ("numpy", "tensor"):
        m = torch.from_numpy(mask) if mask_backing == "tensor" else mask
        got = tqv.T2(_port_map(arr, backing)).to_metrics(dt.MedicalVolume(m, _AFFINE),
                                                         bounds=(0, 100))
        _assert_frames_equal(got, ref)


def test_mask_written_and_read_back_as_uint16(tmp_path):
    """The repro of the fault: a uint16 mask through the port's NIfTI I/O."""
    arr = _map(seed=4)
    dt.NiftiWriter().save(dt.MedicalVolume(_mask(np.uint16), _AFFINE), str(tmp_path / "m.nii.gz"))
    mask = dt.NiftiReader().load(str(tmp_path / "m.nii.gz"))
    assert mask.A.dtype == np.uint16
    ref = jqv.T2(dosma_tpu.MedicalVolume(arr, _AFFINE)).to_metrics(
        dosma_tpu.NiftiReader().load(str(tmp_path / "m.nii.gz")))
    for backing in ("numpy", "tensor"):
        _assert_frames_equal(tqv.T2(_port_map(arr, backing)).to_metrics(mask), ref)


def test_empty_region_and_all_nan_map():
    arr = np.full((4, 4, 2), np.nan, np.float32)
    mask = np.ones((4, 4, 2), np.int32)
    for backing in ("numpy", "tensor"):
        qv = tqv.T2(dt.MedicalVolume(torch.from_numpy(arr) if backing == "tensor" else arr,
                                     np.eye(4)))
        df = qv.to_metrics(dt.MedicalVolume(mask, np.eye(4)))
        assert df["# Voxels"].iloc[0] == 0 and np.isnan(df["Mean"].iloc[0])
        rows = qv.metric_rows()
        assert rows[0]["# Voxels"] == 0 and np.isnan(rows[0]["Median"])


def test_bounds_checks():
    qv = tqv.T2(dt.MedicalVolume(_map(), _AFFINE))
    with pytest.raises(ValueError):
        qv.to_metrics(bounds=(10, 1))
    with pytest.raises(ValueError):
        qv.to_metrics(bounds=(0, 1), closed="sideways")


@pytest.mark.parametrize("backing", ["numpy", "tensor"])
def test_save_and_load_match_jax(tmp_path, backing):
    arr = _map(special=False)
    r2 = np.random.RandomState(1).rand(16, 16, 6).astype(np.float32)
    qv = tqv.T2(_port_map(arr, backing))
    qv.add_additional_volume("r2", dt.MedicalVolume(torch.from_numpy(r2), _AFFINE))
    with pytest.warns(UserWarning, match="only nifti"):
        qv.save_data(str(tmp_path), data_format=dt.ImageDataFormat.dicom)
    assert (tmp_path / "t2" / "t2.nii.gz").is_file()
    assert (tmp_path / "t2" / "t2-r2.nii.gz").is_file()
    back_t, back_j = tqv.T2(), jqv.T2()
    back_t.load_data(str(tmp_path))
    back_j.load_data(str(tmp_path))
    np.testing.assert_array_equal(back_t.volumetric_map.A, arr)
    np.testing.assert_array_equal(back_t.volumetric_map.A, np.asarray(back_j.volumetric_map.A))
    np.testing.assert_array_equal(back_t.volumetric_map.affine, back_j.volumetric_map.affine)
    r2_back = dt.read(str(tmp_path / "t2" / "t2-r2.nii.gz"))
    np.testing.assert_array_equal(r2_back.A, r2)


def test_save_qvs_load_qvs_and_registry(tmp_path):
    t2 = tqv.T2(dt.MedicalVolume(_map(special=False), _AFFINE))
    t1rho = tqv.T1Rho(dt.MedicalVolume(_map(seed=2, special=False), _AFFINE))
    tqv.QuantitativeValue.save_qvs(str(tmp_path), [t2, t1rho])
    with pytest.raises(TypeError):
        tqv.QuantitativeValue.save_qvs(str(tmp_path), [t2, "not a qv"])
    found_t = {type(q).__name__ for q in tqv.QuantitativeValue.load_qvs(str(tmp_path))}
    found_j = {type(q).__name__ for q in jqv.QuantitativeValue.load_qvs(str(tmp_path))}
    assert found_t == found_j == {"T2", "T1Rho"}
    with pytest.raises(TypeError):
        t2.add_additional_volume("r2", np.zeros((2, 2, 2)))
    assert dt.quant_vals.get_qv("t2").NAME == "t2" and dt.quant_vals.get_qv(1).NAME == "t1_rho"


def test_to_moves_the_map_and_its_companions():
    qv = tqv.T2(dt.MedicalVolume(_map(special=False), _AFFINE))
    qv.add_additional_volume("r2", dt.MedicalVolume(_map(seed=5, special=False), _AFFINE))
    assert qv.to("cpu") is qv
    assert qv.volumetric_map.device == dt.cpu_device
    assert all(v.device == dt.cpu_device for v in qv.additional_volumes.values())


def _same_rows(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            va, vb = ra[k], rb[k]
            assert va == vb or (isinstance(va, float) and np.isnan(va) and np.isnan(vb)), (k, va, vb)


@pytest.mark.parametrize("name", [k for k, v in _CASES.items() if v[0]])
def test_gathered_rows_equal_the_host_rows_bit_for_bit(name):
    """A tensor-backed map with a mask is gathered, split and reduced on its
    device; a host map takes the same torch reductions on the CPU, so the
    rows of the two must be equal exactly, ``fns`` included (they see the
    same values in the same order)."""
    _, bounds, closed, fns, labels = _CASES[name]
    arr = _map(seed=7)
    for mask_backing in ("numpy", "tensor"):
        m = _mask(np.uint16)
        mask = dt.MedicalVolume(torch.from_numpy(m) if mask_backing == "tensor" else m, _AFFINE)
        rows = {b: tqv.T2(_port_map(arr, b)).metric_rows(mask, labels, bounds, closed, fns)
                for b in ("numpy", "tensor")}
        _same_rows(rows["tensor"], rows["numpy"])
