"""The port's ``MedicalVolume``, ``Device`` and preferences against the JAX
package's, on the same numpy arrays and affines."""

import numpy as np
import pytest
import torch

import dosma_tpu
import dosma_tpu_torch
from dosma_tpu_torch.core.device import Device, get_device, to_device


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_ORIENTATIONS = [
    ("SI", "AP", "LR"),
    ("AP", "LR", "SI"),
    ("IS", "PA", "RL"),
    ("LR", "SI", "AP"),
]


def _pair(seed=0, shape=(6, 5, 4), orientation=dosma_tpu.SAGITTAL, as_tensor=False):
    rs = np.random.RandomState(seed)
    arr = rs.randn(*shape).astype(np.float32)
    affine = dosma_tpu.to_affine(orientation, spacing=(0.5, 0.7, 1.5), origin=(10, -3, 2.5))
    vt = torch.from_numpy(arr.copy()) if as_tensor else arr.copy()
    return dosma_tpu.MedicalVolume(arr, affine), dosma_tpu_torch.MedicalVolume(vt, affine)


def _same(mj, mt):
    np.testing.assert_array_equal(mt.affine, mj.affine)
    assert mt.orientation == mj.orientation
    assert mt.shape == mj.shape
    vt = mt.A.numpy() if isinstance(mt.A, torch.Tensor) else np.asarray(mt.A)
    np.testing.assert_array_equal(vt, np.asarray(mj.A))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("target", _ORIENTATIONS)
def test_reformat_matches_jax(target, as_tensor):
    mj, mt = _pair(as_tensor=as_tensor)
    _same(mj.reformat(target), mt.reformat(target))
    other_j, other_t = _pair(seed=1, orientation=target)
    _same(mj.reformat_as(other_j), mt.reformat_as(other_t))
    # in place
    mt.reformat(target, inplace=True)
    _same(mj.reformat(target), mt)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize(
    "slicer",
    [
        (slice(1, 4), slice(None), slice(0, 2)),
        (slice(None, None, 2), slice(4, 0, -1), slice(None)),
        (slice(-3, None), slice(1, 5, 3), slice(3, None, -2)),
        Ellipsis,
    ],
    ids=["start_stop", "steps_and_reverse", "negative_starts", "ellipsis"],
)
def test_slicing_affine_matches_jax(slicer, as_tensor):
    mj, mt = _pair(as_tensor=as_tensor)
    _same(mj[slicer], mt[slicer])


def test_slicing_rejects_scalar_spatial_index():
    _, mt = _pair()
    with pytest.raises(IndexError):
        mt[0]


def test_is_same_dimensions_matches_jax():
    mj, mt = _pair()
    oj, ot = _pair(seed=3)
    assert mt.is_same_dimensions(ot) == mj.is_same_dimensions(oj) is True
    shifted = ot.affine.copy()
    shifted[0, 3] += 1e-6
    sj = dosma_tpu.MedicalVolume(np.asarray(oj.A), shifted)
    st = dosma_tpu_torch.MedicalVolume(ot.A, shifted)
    for precision in (None, 4, 8):
        assert mt.is_same_dimensions(st, precision) == mj.is_same_dimensions(sj, precision)
    rj, rt = mj.reformat(dosma_tpu.AXIAL), mt.reformat(dosma_tpu.AXIAL)
    assert mt.is_same_dimensions(rt) == mj.is_same_dimensions(rj) is False
    with pytest.raises(ValueError):
        mt.is_same_dimensions(rt, err=True)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_arithmetic_matches_jax(as_tensor):
    mj, mt = _pair(as_tensor=as_tensor)
    oj, ot = _pair(seed=5, as_tensor=as_tensor)
    results = [
        (mj + oj, mt + ot),
        (mj - 2.5, mt - 2.5),
        (3 * mj, 3 * mt),
        (mj / (abs(oj) + 1), mt / (abs(ot) + 1)),
        (mj ** 2, mt ** 2),
        (-mj, -mt),
        (mj > 0, mt > 0),
        (mj == oj, mt == ot),
        (np.maximum(mj, 0.1), np.maximum(mt, 0.1)),
        (np.exp(mj), np.exp(mt)),
    ]
    for rj, rt in results:
        assert isinstance(rt, dosma_tpu_torch.MedicalVolume)
        assert isinstance(rt.A, torch.Tensor) == as_tensor
        np.testing.assert_array_equal(rt.affine, rj.affine)
        vt = rt.A.numpy() if as_tensor else rt.A
        np.testing.assert_allclose(vt, np.asarray(rj.A), rtol=1e-6)

    ij, it = mj.clone(), mt.clone()
    ij += oj
    it += ot
    it *= 2
    ij *= 2
    _same(ij, it)
    assert (mt.A == _pair(as_tensor=as_tensor)[1].A).all()  # clone left mt untouched


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("ufunc", [np.add, np.multiply, np.maximum, np.minimum])
def test_reduce_over_non_spatial_axis_matches_jax(ufunc, as_tensor):
    headers = np.array([{"EchoTime": t} for t in range(3)], dtype=object)
    mj, mt = _pair(shape=(4, 5, 2, 3), as_tensor=as_tensor)
    mj = dosma_tpu.MedicalVolume(np.asarray(mj.A), mj.affine, headers=headers)
    mt = dosma_tpu_torch.MedicalVolume(mt.A, mt.affine, headers=headers)
    for kwargs in ({"axis": 3}, {"axis": -1, "keepdims": True}):
        rj, rt = ufunc.reduce(mj, **kwargs), ufunc.reduce(mt, **kwargs)
        assert rt.shape == rj.shape and rt.headers().shape == rj.headers().shape
        vt = rt.A.numpy() if as_tensor else rt.A
        np.testing.assert_allclose(vt, np.asarray(rj.A), rtol=1e-6)
    with pytest.raises(ValueError):
        ufunc.reduce(mt, axis=0)


def test_arithmetic_rejects_mismatched_volumes():
    _, mt = _pair()
    _, rt = _pair(orientation=dosma_tpu.AXIAL)
    with pytest.raises(ValueError):
        mt + rt


def test_clone_astype_headers_and_device():
    headers = np.array([{"EchoTime": 10.0}], dtype=object)
    arr = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    mt = dosma_tpu_torch.MedicalVolume(arr, np.eye(4), headers=headers)
    assert mt.headers().shape == (1, 1, 1)
    c = mt.clone()
    assert c.headers()[0, 0, 0] is not headers[0]
    assert c.astype(np.float32).dtype == np.float32
    t = dosma_tpu_torch.MedicalVolume(torch.from_numpy(arr), np.eye(4)).astype(np.float32)
    assert t.dtype == torch.float32
    assert mt.device == dosma_tpu_torch.cpu_device == Device("cpu") == Device(-1)
    assert mt.to("cpu") is mt and mt.cpu() is mt
    assert get_device(torch.zeros(1)) == Device(torch.device("cpu"))
    assert isinstance(to_device(torch.zeros(3), "cpu"), np.ndarray)
    assert mt.pixel_spacing == (1.0, 1.0, 1.0) and mt.scanner_origin == (0.0, 0.0, 0.0)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_copy_to_host_async_is_a_no_op_on_the_host(as_tensor):
    """A host volume (numpy or a CPU tensor) starts no copy: the call returns
    the volume unchanged, as ``dosma_tpu``'s does for a host array, and
    survives pickling and deep copies."""
    import copy
    import pickle

    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    mt = dosma_tpu_torch.MedicalVolume(torch.from_numpy(arr) if as_tensor else arr, np.eye(4))
    vol = mt.volume
    assert mt.copy_to_host_async() is mt
    assert mt.volume is vol and mt._host_copy is None
    assert mt.cpu() is mt
    for other in (copy.deepcopy(mt), pickle.loads(pickle.dumps(mt))):
        np.testing.assert_array_equal(np.asarray(other), arr)
        assert other._host_copy is None
    mj = dosma_tpu.MedicalVolume(arr, np.eye(4))
    assert mj.copy_to_host_async() is mj


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for spec in ("cuda", "cuda:0", 0, torch.device("cuda")):
        with pytest.raises(RuntimeError):
            Device(spec)
    _, mt = _pair()
    with pytest.raises(RuntimeError):
        mt.to("cuda")
    assert Device(-1) != "cuda"


def test_preferences_match_jax_template():
    import yaml

    from dosma_tpu.defaults import _template_path, _walk_leaves

    with open(_template_path()) as f:
        template = {path: leaf["value"] for path, leaf in _walk_leaves(yaml.safe_load(f))}
    prefs = dosma_tpu_torch.preferences
    assert prefs.keys()
    for key in prefs.keys():
        assert prefs.get(key) == template[key], key
    assert prefs.fitting_r2_threshold == 0.9
    assert dosma_tpu_torch.defaults.AFFINE_DECIMAL_PRECISION == dosma_tpu.defaults.AFFINE_DECIMAL_PRECISION
    assert (
        dosma_tpu_torch.defaults.SCANNER_ORIGIN_DECIMAL_PRECISION
        == dosma_tpu.defaults.SCANNER_ORIGIN_DECIMAL_PRECISION
    )
