"""numpy functions on the port's volumes against the JAX package's.

The cases of ``tests/core/test_numpy_routines.py``, each on a host (numpy)
volume and on a tensor-backed one (a CPU tensor here; a card's tensor takes
the same torch code). The port's result must be a volume with the JAX
package's shape, affine and headers layout, and values equal to the JAX
package's host result (bit for bit where the operation is exact, else
within 1e-12 relative in float64); a tensor-backed volume's result stays a
tensor.
"""

import numpy as np
import pytest
import torch

import dosma_tpu
import dosma_tpu_torch as dt
from dosma_tpu.core.orientation import AXIAL, SAGITTAL, to_affine
from tests.util import build_dummy_headers


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


@pytest.fixture(params=["numpy", "tensor"])
def backing(request):
    return request.param


def _pair(arr, affine, backing, headers=None):
    """(port volume, JAX package volume) over the same data."""
    vol = torch.from_numpy(arr.copy()) if backing == "tensor" else arr.copy()
    return dt.MedicalVolume(vol, affine, headers=headers), dosma_tpu.MedicalVolume(arr.copy(), affine,
                                                                                 headers=headers)


def _build(backing, shape=(4, 5, 6), nd_extra=0, seed=0, headers=False, nan=False):
    rs = np.random.RandomState(seed)
    full = shape + (2,) * nd_extra
    arr = rs.rand(*full)
    if nan:
        arr[(0,) * arr.ndim] = np.nan
    h = build_dummy_headers(full[2:]) if headers else None
    return _pair(arr, to_affine(SAGITTAL), backing, headers=h)


def _values(x):
    if isinstance(x, (dt.MedicalVolume, dosma_tpu.MedicalVolume)):
        x = x.A
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _assert_same(got, ref, backing, exact=False):
    if isinstance(ref, dosma_tpu.MedicalVolume):
        assert isinstance(got, dt.MedicalVolume)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got.affine, ref.affine)
        assert (got.headers() is None) == (ref.headers() is None)
        if ref.headers() is not None:
            assert got.headers().shape == ref.headers().shape
        assert isinstance(got.A, torch.Tensor) == (backing == "tensor")
    g, r = _values(got), _values(ref)
    if exact or g.dtype.kind in "biu":
        np.testing.assert_array_equal(g, r)
    else:
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=0, equal_nan=True)


_REDUCTIONS = [np.sum, np.mean, np.std, np.amin, np.amax, np.argmin, np.argmax, np.nanmin,
               np.nanmax, np.nanargmin, np.nanargmax, np.nansum, np.nanmean, np.nanstd]


@pytest.mark.parametrize("fn", _REDUCTIONS, ids=lambda f: f.__name__)
def test_reduction_over_the_last_axis(backing, fn):
    t, j = _build(backing, nd_extra=1, nan=fn.__name__.startswith("nan"))
    _assert_same(fn(t, axis=-1), fn(j, axis=-1), backing)


@pytest.mark.parametrize("fn", [np.sum, np.mean, np.std, np.amin, np.amax, np.nanmean],
                         ids=lambda f: f.__name__)
def test_whole_volume_reductions_give_scalars(backing, fn):
    t, j = _build(backing, seed=1)
    assert np.isclose(float(fn(t)), float(fn(j)), rtol=1e-12, atol=0)


def test_methods_keepdims_and_ddof(backing):
    t, j = _build(backing, nd_extra=1, seed=2)
    _assert_same(t.sum(axis=-1, keepdims=True), j.sum(axis=-1, keepdims=True), backing)
    _assert_same(t.mean(axis=-1), j.mean(axis=-1), backing)
    _assert_same(t.std(axis=-1, ddof=1), j.std(axis=-1, ddof=1), backing)
    _assert_same(t.min(axis=-1), j.min(axis=-1), backing)
    _assert_same(t.max(axis=-1), j.max(axis=-1), backing)
    _assert_same(t.round(2), j.round(2), backing)
    with pytest.raises(ValueError, match="spatial"):
        t.sum(axis=0)


def test_all_any(backing):
    t, j = _build(backing)
    for thr in (-1, 0.5):
        assert bool(np.all(t > thr)) == bool(np.all(j > thr))
        assert bool(np.any(t > thr)) == bool(np.any(j > thr))


def test_nan_to_num(backing):
    t, j = _build(backing, nan=True)
    _assert_same(np.nan_to_num(t, nan=7.0), np.nan_to_num(j, nan=7.0), backing, exact=True)


def test_clip_with_scalars_and_volumes(backing):
    t, j = _build(backing)
    _assert_same(np.clip(t, 0.2, 0.8), np.clip(j, 0.2, 0.8), backing, exact=True)
    lo_t, lo_j = _build(backing, seed=3)
    _assert_same(np.clip(t, lo_t * 0.5, None), np.clip(j, lo_j * 0.5, None), backing, exact=True)


@pytest.mark.parametrize("decimals", [0, 1, 3])
def test_around(backing, decimals):
    t, j = _build(backing)
    _assert_same(np.around(t, decimals), np.around(j, decimals), backing, exact=True)


def test_zeros_ones_like(backing):
    t, j = _build(backing)
    _assert_same(np.zeros_like(t), np.zeros_like(j), backing, exact=True)
    _assert_same(np.ones_like(t), np.ones_like(j), backing, exact=True)


def test_stack(backing):
    t, j = _build(backing, headers=True)
    _assert_same(np.stack([t, t]), np.stack([j, j]), backing, exact=True)
    with pytest.raises(ValueError):
        np.stack([t, t], axis=0)


def test_stack_reorients_to_the_first(backing):
    t, j = _build(backing)
    _assert_same(np.stack([t, t.reformat(AXIAL)], axis=-1),
                 np.stack([j, j.reformat(AXIAL)], axis=-1), backing, exact=True)


def test_concatenate(backing):
    t, j = _build(backing, nd_extra=1)
    _assert_same(np.concatenate([t, t], axis=-1), np.concatenate([j, j], axis=-1), backing,
                 exact=True)
    t3, j3 = _build(backing)
    affine2 = j3.affine.copy()
    affine2[:3, 3] = (j3.affine @ np.array([0, 0, j3.shape[2], 1.0]))[:3]
    t4, j4 = _pair(np.asarray(j3.A), affine2, backing)
    _assert_same(np.concatenate([t3, t4], axis=2), np.concatenate([j3, j4], axis=2), backing,
                 exact=True)
    with pytest.raises(ValueError):
        np.concatenate([t3, t3], axis=2)
    t5, _ = _pair(np.asarray(j.A), to_affine(SAGITTAL, origin=(5, 5, 5)), backing)
    with pytest.raises(ValueError):
        np.concatenate([t, t5], axis=-1)


def test_expand_dims_and_squeeze(backing):
    t, j = _build(backing)
    _assert_same(np.expand_dims(t, -1), np.expand_dims(j, -1), backing, exact=True)
    _assert_same(np.squeeze(np.expand_dims(t, -1)), np.squeeze(np.expand_dims(j, -1)), backing,
                 exact=True)
    with pytest.raises(ValueError):
        np.expand_dims(t, 0)
    flat, _ = _pair(np.zeros((1, 5, 6)), np.eye(4), backing)
    with pytest.raises(ValueError):
        np.squeeze(flat, 0)


@pytest.mark.parametrize("pad_width", [((1, 1), (2, 2), (3, 3)), 1, ((1, 0), (0, 0), (0, 2))])
def test_pad_shifts_origin(backing, pad_width):
    arr = np.random.RandomState(0).rand(3, 4, 5)
    t, j = _pair(arr, to_affine(AXIAL, (1, 1, 1), (10, 20, 30)), backing)
    _assert_same(np.pad(t, pad_width), np.pad(j, pad_width), backing, exact=True)


def test_where(backing):
    t, j = _pair(np.arange(24.0).reshape(2, 3, 4), np.eye(4), backing)
    _assert_same(np.where(t > 10, t, 0), np.where(j > 10, j, 0), backing, exact=True)
    got = np.where(t > 10)
    ref = np.where(j > 10)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_values(g), r)


def test_where_indices_assign(backing):
    t, _ = _pair(np.ones((10, 20, 30)), np.eye(4), backing)
    t[np.where(_values(t) == 1)] = 5
    assert np.all(_values(t) == 5)


def test_setitem_slices_and_volumes(backing):
    t, j = _build(backing, seed=4)
    for v in (t, j):
        v[1:3, :, 2:4] = 0.5
    _assert_same(t, j, backing, exact=True)
    src_t, src_j = _build(backing, seed=5)
    t[:2, :2, :2] = src_t[:2, :2, :2]
    j[:2, :2, :2] = src_j[:2, :2, :2]
    _assert_same(t, j, backing, exact=True)


def test_ufuncs_and_ndarray_arithmetic(backing):
    t, j = _pair(np.ones((4, 5, 6)), np.eye(4), backing)
    _assert_same(np.exp(t), np.exp(j), backing)
    _assert_same(np.sqrt(t), np.sqrt(j), backing)
    _assert_same(np.log(t + 1), np.log(j + 1), backing)
    _assert_same(t + np.ones(t.shape), j + np.ones(j.shape), backing, exact=True)
    _assert_same(3 * t, 3 * j, backing, exact=True)


def test_shares_memory(backing):
    arr = np.random.rand(3, 4, 5)
    base = torch.from_numpy(arr) if backing == "tensor" else arr
    mv1, mv2 = dt.MedicalVolume(base, np.eye(4)), dt.MedicalVolume(base, np.eye(4))
    mv3 = mv1.clone()
    assert np.shares_memory(mv1, mv2) and np.may_share_memory(mv1, mv2)
    assert not np.shares_memory(mv1, mv3)


def test_is_identical_and_equality(backing):
    t, _ = _build(backing)
    assert t.is_identical(t.clone())
    other = t.clone()
    other[:1, :1, :1] = -1.0
    assert not t.is_identical(other)
    assert bool(np.all(_values(t == t.clone())))
    with pytest.raises(TypeError):
        hash(t)  # volumes compare elementwise, so they are unhashable, as in dosma_tpu
    with pytest.raises(TypeError):
        hash(dosma_tpu.MedicalVolume(np.zeros((2, 2, 2)), np.eye(4)))
