"""The slice as a whole: a DICOM series in, a T2 map and its metrics out.

A 32x32x8 x 4-echo monoexponential series (uint16 pixels, echo times in
the headers) is written by ``dosma_tpu``'s DICOM writer, then read, fitted
(``MonoExponentialFit(tc0="polyfit")``) and reduced to regional metrics
(``T2.to_metrics``) by both packages. The JAX fit runs its Pallas kernel in
interpret mode (``pallas_supported`` patched to True, as
``tests/test_torch_fitting.py`` does); the port fits on the CPU with its
plain version, from host volumes (``DicomReader``) and from CPU tensors
(``load_to_device``).

Tolerances (those of ``tests/test_torch_monoexp.py``): unrounded T2
within 1e-4 relative on noiseless data and 1e-3 on noisy data (each voxel
freezes at its own latch in the port); metric rows: categories and voxel
counts identical, Mean / Std / Median within the same relative tolerance.

Also here, unsigned volumes (DICOM pixels are uint16): the port widens
uint16 to int32 and uint32 to int64 where a host array becomes a tensor,
and ``reformat`` with a flip, ``+``, ``>`` and ``abs`` then give the JAX
package's values (torch has no CPU flip, comparison or arithmetic for the
unsigned types, and these raised before).
"""

import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import dosma_tpu
import dosma_tpu_torch as dt
from dosma_tpu.core.io.dicom import write_dicom
from dosma_tpu.core.io.dicom.writer import generate_uid
from dosma_tpu.ops import monoexp_pallas
from tests.util import build_dicom_dataset


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_TE = (10.0, 20.0, 30.0, 40.0)
_SHAPE = (32, 32, 8)


def _write_series(path, noise, seed=0):
    """Monoexponential echoes A*exp(-TE/T2) as uint16, one file per slice and
    echo, grouped by EchoNumbers with EchoTime set. Returns the labels."""
    rs = np.random.RandomState(seed)
    t2 = rs.rand(*_SHAPE) * 50 + 20
    amp = 20000 + 5000 * rs.rand(*_SHAPE)
    series_uid = generate_uid()
    os.makedirs(path, exist_ok=True)
    i = 0
    for e, te in enumerate(_TE):
        echo = amp * np.exp(-te / t2) * (1 + noise * rs.randn(*_SHAPE))
        echo = np.clip(np.round(echo), 0, 65535).astype(np.uint16)
        for s in range(_SHAPE[2]):
            ds = build_dicom_dataset(echo[:, :, s], instance_number=i + 1, echo_number=e + 1,
                                     echo_time=te, position=(0.0, 0.0, 1.5 * s),
                                     spacing=(0.4, 0.4), series_uid=series_uid)
            write_dicom(ds, os.path.join(path, f"I{i + 1:04d}.dcm"))
            i += 1
    labels = np.zeros(_SHAPE, np.uint16)
    labels[4:28, 4:28, :4] = 1
    labels[8:24, 8:24, 4:] = 2
    return labels


def _jax_path(path, labels, monkeypatch):
    vols = dosma_tpu.DicomReader().load(path)
    x = [v.get_metadata("EchoTime") for v in vols]
    mask = dosma_tpu.MedicalVolume(labels, vols[0].affine)
    monkeypatch.setattr(monoexp_pallas, "pallas_supported", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        tc, r2 = dosma_tpu.MonoExponentialFit(tc0="polyfit", decimal_precision=None).fit(
            x, vols, mask=mask)
    return vols, tc, dosma_tpu.T2(tc).to_metrics(mask)


def _port_path(path, labels, loader):
    vols = dt.DicomReader().load(path) if loader == "reader" else dt.load_to_device(path)
    x = [v.get_metadata("EchoTime") for v in vols]
    mask = dt.MedicalVolume(labels, vols[0].affine)
    tc, r2 = dt.MonoExponentialFit(tc0="polyfit", decimal_precision=None).fit(x, vols, mask=mask)
    return vols, tc, dt.T2(tc).to_metrics(mask)


@pytest.mark.parametrize("loader", ["reader", "load_to_device"])
@pytest.mark.parametrize("noise,rtol", [(0.0, 1e-4), (0.01, 1e-3)], ids=["noiseless", "noisy"])
def test_dicom_to_metrics_matches_jax(tmp_path, monkeypatch, loader, noise, rtol):
    labels = _write_series(str(tmp_path), noise)
    vols_j, tc_j, df_j = _jax_path(str(tmp_path), labels, monkeypatch)
    vols_t, tc_t, df_t = _port_path(str(tmp_path), labels, loader)

    assert len(vols_t) == len(vols_j) == 4
    for vt, vj in zip(vols_t, vols_j):
        want = torch.int32 if loader == "load_to_device" else np.uint16
        assert vt.A.dtype == want
        np.testing.assert_array_equal(np.asarray(vt.A), np.asarray(vj.A))
        np.testing.assert_array_equal(vt.affine, vj.affine)

    a_t = tc_t.A.numpy() if isinstance(tc_t.A, torch.Tensor) else tc_t.A
    a_j = np.asarray(tc_j.A)
    np.testing.assert_array_equal(tc_t.affine, tc_j.affine)
    np.testing.assert_array_equal(a_t == 0, a_j == 0)
    np.testing.assert_allclose(a_t, a_j, rtol=rtol, atol=0)

    assert list(df_t["Category"]) == list(df_j["Category"]) == ["label_1", "label_2", "total"]
    assert list(df_t["# Voxels"]) == list(df_j["# Voxels"])
    for col in ("Mean", "Std", "Median"):
        np.testing.assert_allclose(df_t[col].to_numpy(float), df_j[col].to_numpy(float),
                                   rtol=rtol, atol=0)


def test_maps_round_trip_through_nifti_and_dicom(tmp_path, monkeypatch):
    labels = _write_series(str(tmp_path / "series"), 0.0)
    vols_t, tc_t, _ = _port_path(str(tmp_path / "series"), labels, "reader")
    qv = dt.T2(tc_t)
    qv.save_data(str(tmp_path / "maps"))
    back = dt.T2()
    back.load_data(str(tmp_path / "maps"))
    assert back.volumetric_map.is_identical(tc_t)
    dt.write(vols_t[2], str(tmp_path / "echo3"), data_format=dt.ImageDataFormat.dicom)
    again = dosma_tpu.read(str(tmp_path / "echo3"))
    assert len(again) == 1
    np.testing.assert_array_equal(np.asarray(again[0].A), vols_t[2].A)
    np.testing.assert_array_equal(again[0].affine, vols_t[2].affine)


# ----------------------------------------------------------------------
# Unsigned volumes
# ----------------------------------------------------------------------
@pytest.fixture(params=[np.uint16, np.uint32])
def unsigned_pair(request):
    rs = np.random.RandomState(9)
    arr = (rs.rand(6, 5, 4) * 60000).astype(request.param)
    affine = dosma_tpu.to_affine(dosma_tpu.SAGITTAL, spacing=(0.5, 0.6, 2.0), origin=(1, 2, 3))
    return arr, affine


def test_unsigned_host_volumes_keep_their_dtype(unsigned_pair):
    arr, affine = unsigned_pair
    assert dt.MedicalVolume(arr, affine).A.dtype == arr.dtype


def test_unsigned_tensors_are_widened(unsigned_pair):
    arr, affine = unsigned_pair
    wide = {np.dtype(np.uint16): torch.int32, np.dtype(np.uint32): torch.int64}[arr.dtype]
    host = dt.MedicalVolume(arr, affine)
    mask_like = dt.MedicalVolume(torch.zeros(arr.shape, dtype=torch.float32), affine)
    for mv in (dt.MedicalVolume(torch.from_numpy(arr), affine),  # constructor
               host._partial_clone(volume=torch.from_numpy(arr)),
               mask_like + host):  # a host operand of a tensor-backed volume
        assert mv.A.dtype in (wide, torch.float32)
        np.testing.assert_array_equal(mv.A.numpy(), arr.astype(np.int64))
    assert dt.to_device(arr, "cpu").dtype == arr.dtype  # host data stays host data
    from dosma_tpu_torch.core.device import as_tensor

    assert as_tensor(arr).dtype == wide


@pytest.mark.parametrize("orientation", [("RL", "PA", "IS"), ("AP", "IS", "LR"),
                                         ("IS", "RL", "PA")])
def test_unsigned_reformat_with_flips_matches_jax(unsigned_pair, orientation):
    arr, affine = unsigned_pair
    ref = dosma_tpu.MedicalVolume(arr, affine).reformat(orientation)
    got = dt.MedicalVolume(torch.from_numpy(arr), affine).reformat(orientation)
    np.testing.assert_array_equal(got.A.numpy(), np.asarray(ref.A).astype(np.int64))
    np.testing.assert_array_equal(got.affine, ref.affine)


def test_unsigned_arithmetic_matches_jax(unsigned_pair):
    arr, affine = unsigned_pair
    small = arr // 4  # no wrap-around in the unsigned type
    j = dosma_tpu.MedicalVolume(small, affine)
    t = dt.MedicalVolume(torch.from_numpy(small), affine)
    host = dt.MedicalVolume(small, affine)
    for got, ref in ((t + t, j + j), (t + 7, j + 7), (t > 5000, j > 5000), (abs(t), abs(j)),
                     (t + host, j + j), (t > host, j > j), (t * 2, j * 2), (t // 3, j // 3)):
        np.testing.assert_array_equal(got.A.numpy(), np.asarray(ref.A).astype(got.A.numpy().dtype))
    t += host  # in place, with a host operand
    np.testing.assert_array_equal(t.A.numpy(), 2 * small.astype(np.int64))
