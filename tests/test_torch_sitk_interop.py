"""The port's SimpleITK interop math and ``MedicalVolume.to_sitk`` /
``from_sitk`` against ``dosma_tpu``'s, on seeded volumes and affines.

Neither package needs SimpleITK for this: both take the numpy conversions of
their ``core/sitk_interop.py`` and the ``HeadlessSitkImage`` stand-in.
"""

import numpy as np
import pytest
import torch

import dosma_tpu
import dosma_tpu_torch
from dosma_tpu.core import sitk_interop as jsi
from dosma_tpu_torch.core import sitk_interop as tsi


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


def _affine(rs):
    """A seeded RAS affine: a random rotation (QR of a normal matrix),
    spacings in [0.3, 3) and an origin in [-50, 50)."""
    q, _ = np.linalg.qr(rs.randn(3, 3))
    aff = np.eye(4)
    aff[:3, :3] = q * rs.uniform(0.3, 3.0, 3)
    aff[:3, 3] = rs.uniform(-50, 50, 3)
    return aff


def _spacing(aff):
    return tuple(np.sqrt(np.sum(aff[:3, :3] ** 2, axis=0)))


def _equal(a, b):
    """Two results of the interop functions: equal arrays, equal tuples."""
    assert type(a) is type(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("vdim", [None, -1, 3])
def test_four_functions_equal_the_jax_package(seed, vdim):
    rs = np.random.RandomState(seed)
    shape = (5, 4, 3, 2) if vdim is not None else (5, 4, 3)
    vol = rs.rand(*shape).astype(np.float32)
    aff = _affine(rs)
    sp = _spacing(aff)
    pj = jsi.medvol_to_sitk_params(vol, aff, sp, vdim=vdim)
    pt = tsi.medvol_to_sitk_params(vol, aff, sp, vdim=vdim)
    _equal(pt, pj)
    vec = vdim is not None
    _equal(tsi.permute_inplane_params(*pt, is_vector=vec),
           jsi.permute_inplane_params(*pj, is_vector=vec))
    _equal(tsi.sitk_params_to_medvol(*pt, is_vector=vec),
           jsi.sitk_params_to_medvol(*pj, is_vector=vec))
    it = tsi.HeadlessSitkImage(*pt, is_vector=vec)
    ij = jsi.HeadlessSitkImage(*pj, is_vector=vec)
    for name in ("GetSize", "GetOrigin", "GetSpacing", "GetDirection",
                 "GetNumberOfComponentsPerPixel"):
        assert getattr(it, name)() == getattr(ij, name)(), name
    np.testing.assert_array_equal(it.array_from_image(copy=True), ij.array_from_image())


@pytest.mark.parametrize("transpose_inplane", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_to_sitk_matches_jax_and_round_trips(as_tensor, transpose_inplane):
    rs = np.random.RandomState(7)
    vol = rs.rand(7, 6, 5).astype(np.float32)
    aff = _affine(rs)
    mj = dosma_tpu.MedicalVolume(vol, aff)
    mt = dosma_tpu_torch.MedicalVolume(torch.from_numpy(vol.copy()) if as_tensor else vol, aff)
    ij = mj.to_sitk(headless=True, transpose_inplane=transpose_inplane)
    it = mt.to_sitk(headless=True, transpose_inplane=transpose_inplane)
    assert isinstance(it, tsi.HeadlessSitkImage)
    assert it.GetSize() == ij.GetSize() and it.GetOrigin() == ij.GetOrigin()
    assert it.GetSpacing() == ij.GetSpacing() and it.GetDirection() == ij.GetDirection()
    np.testing.assert_array_equal(it.array_from_image(), ij.array_from_image())

    back = dosma_tpu_torch.MedicalVolume.from_sitk(it, transpose_inplane=transpose_inplane)
    back_j = dosma_tpu.MedicalVolume.from_sitk(ij, transpose_inplane=transpose_inplane)
    assert isinstance(back.A, np.ndarray)
    np.testing.assert_array_equal(back.A, vol)
    np.testing.assert_array_equal(back.affine, back_j.affine)
    np.testing.assert_allclose(back.affine, aff, atol=1e-10)


def test_vector_volume_and_copy_semantics():
    rs = np.random.RandomState(5)
    vol = rs.rand(4, 5, 6, 3).astype(np.float32)
    mt = dosma_tpu_torch.MedicalVolume(vol, np.eye(4))
    img = mt.to_sitk(vdim=-1, headless=True)
    assert img.GetNumberOfComponentsPerPixel() == 3 and img.GetSize() == (4, 5, 6)
    np.testing.assert_array_equal(dosma_tpu_torch.MedicalVolume.from_sitk(img).A, vol)
    # copy=False shares the image's array; copy=True does not.
    shared = dosma_tpu_torch.MedicalVolume.from_sitk(img)
    copied = dosma_tpu_torch.MedicalVolume.from_sitk(img, copy=True)
    img.array_from_image()[0, 0, 0, 0] = -1.0
    assert shared.A[0, 0, 0, 0] == -1.0 and copied.A[0, 0, 0, 0] != -1.0


def test_sitk_and_nibabel_branches_raise_without_the_package():
    from dosma_tpu_torch.utils import env

    mt = dosma_tpu_torch.MedicalVolume(np.zeros((3, 3, 3), np.float32), np.eye(4))
    with pytest.raises(ValueError, match="3D"):
        dosma_tpu_torch.MedicalVolume.from_sitk(
            tsi.HeadlessSitkImage(np.zeros((3, 3)), (0, 0), (1, 1), np.eye(2).ravel()))
    if not env.sitk_available():
        with pytest.raises(ImportError, match="SimpleITK"):
            mt.to_sitk()
    if not env.nibabel_available():
        with pytest.raises(ImportError, match="nibabel"):
            mt.to_nib()
        with pytest.raises(ImportError, match="nibabel"):
            dosma_tpu_torch.MedicalVolume.from_nib(object())
