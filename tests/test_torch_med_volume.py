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


# ----------------------------------------------------------------------
# In-place operators: a mixed pair takes what the binary operator gives
# ----------------------------------------------------------------------
_IOPS = [("__iadd__", "__add__"), ("__isub__", "__sub__"), ("__imul__", "__mul__"),
         ("__itruediv__", "__truediv__"), ("__ifloordiv__", "__floordiv__"),
         ("__ipow__", "__pow__")]
_OPERANDS = ["scalar", "host array", "host volume", "tensor", "tensor volume"]


def _operand(kind, affine):
    arr = np.random.RandomState(9).uniform(1, 2, (6, 5, 4)).astype(np.float32)
    return {"scalar": 1.75, "host array": arr, "tensor": torch.from_numpy(arr),
            "host volume": dosma_tpu_torch.MedicalVolume(arr, affine),
            "tensor volume": dosma_tpu_torch.MedicalVolume(torch.from_numpy(arr), affine)}[kind]


@pytest.mark.parametrize("as_tensor", [False, True], ids=["host", "tensor"])
@pytest.mark.parametrize("kind", _OPERANDS)
@pytest.mark.parametrize("iop,op", _IOPS, ids=[i for i, _ in _IOPS])
def test_inplace_operator_equals_the_binary_operator(iop, op, kind, as_tensor):
    """``mv op= x`` leaves ``mv`` (the same object) with the values, dtype and
    kind of array that ``mv op x`` gives, for every operand kind. The JAX
    package's host ``_iops`` ignores numpy's NotImplemented (a silent no-op
    for a device operand), so the binary operator is the oracle here."""
    arr = np.random.RandomState(8).uniform(1, 2, (6, 5, 4)).astype(np.float32)
    affine = dosma_tpu.to_affine(dosma_tpu.SAGITTAL, spacing=(0.5, 0.7, 1.5))
    mv = dosma_tpu_torch.MedicalVolume(torch.from_numpy(arr) if as_tensor else arr, affine)
    other = _operand(kind, affine)
    want = getattr(mv, op)(other)
    same = mv
    out = getattr(mv, iop)(other)
    assert out is same
    assert type(mv.A) is type(want.A) and mv.dtype == want.dtype
    got = mv.A.numpy() if isinstance(mv.A, torch.Tensor) else mv.A
    exp = want.A.numpy() if isinstance(want.A, torch.Tensor) else want.A
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(mv.affine, affine)
    mixed = kind != "scalar" and as_tensor != kind.startswith("tensor")
    if not mixed:  # a pair of one kind is updated in its own storage
        assert isinstance(mv.A, torch.Tensor) == as_tensor


def test_inplace_dtype_rules():
    """A mixed pair takes the binary operator's promoted dtype; a pair of one
    kind keeps numpy's and torch's own in-place casting."""
    f64 = np.full((2, 3, 4), 0.5)
    host = dosma_tpu_torch.MedicalVolume(np.ones((2, 3, 4), np.float32), np.eye(4))
    host += torch.from_numpy(f64)
    assert isinstance(host.A, torch.Tensor) and host.dtype == torch.float64
    tens = dosma_tpu_torch.MedicalVolume(torch.ones(2, 3, 4), np.eye(4))
    tens += f64
    assert tens.dtype == torch.float64 and float(tens.A[0, 0, 0]) == 1.5
    tens = dosma_tpu_torch.MedicalVolume(torch.ones(2, 3, 4), np.eye(4))
    tens += dosma_tpu_torch.MedicalVolume(np.full((2, 3, 4), 3, np.uint16), np.eye(4))
    assert tens.dtype == torch.float32 and float(tens.A[0, 0, 0]) == 4.0
    host = dosma_tpu_torch.MedicalVolume(np.ones((2, 3, 4), np.float32), np.eye(4))
    host += f64
    assert host.dtype == np.float32 and isinstance(host.A, np.ndarray)
    tens = dosma_tpu_torch.MedicalVolume(torch.ones(2, 3, 4), np.eye(4))
    tens += torch.from_numpy(f64)
    assert tens.dtype == torch.float32
    with pytest.raises(ValueError):
        tens += dosma_tpu_torch.MedicalVolume(np.ones((2, 3, 4)), 2 * np.eye(4))


# ----------------------------------------------------------------------
# to_torch / from_torch, is_mmap / materialize
# (tests/core/test_med_volume.py:290-379, :523-532)
# ----------------------------------------------------------------------
def test_to_torch_matches_jax_and_shares_memory():
    arr = np.random.RandomState(0).rand(4, 5, 6).astype(np.float32)
    mt = dosma_tpu_torch.MedicalVolume(arr.copy(), np.eye(4))
    t = mt.to_torch()
    want = dosma_tpu.MedicalVolume(arr, np.eye(4)).to_torch()
    np.testing.assert_array_equal(t.numpy(), want.numpy())
    t[0, 0, 0] = 99.0  # a host volume's array, without a copy
    assert float(mt.A[0, 0, 0]) == 99.0
    tv = dosma_tpu_torch.MedicalVolume(torch.from_numpy(arr.copy()), np.eye(4))
    assert tv.to_torch() is tv.A  # a tensor volume's tensor itself
    g = tv.to_torch(requires_grad=True, contiguous=True)
    assert g.requires_grad and g.is_contiguous() and not tv.A.requires_grad


def test_complex_to_torch_and_back_matches_jax():
    rs = np.random.RandomState(0)
    arr = (rs.rand(3, 4, 5) + 1j * rs.rand(3, 4, 5)).astype(np.complex64)
    mj = dosma_tpu.MedicalVolume(arr, np.eye(4))
    for as_tensor in (False, True):
        mt = dosma_tpu_torch.MedicalVolume(torch.from_numpy(arr.copy()) if as_tensor else arr,
                                           np.eye(4))
        assert mt.to_torch().dtype == torch.complex64
        tr, trj = mt.to_torch(view_as_real=True), mj.to_torch(view_as_real=True)
        assert tr.dtype == torch.float32 and tr.shape == (3, 4, 5, 2)
        np.testing.assert_array_equal(tr.numpy(), trj.numpy())
        back = dosma_tpu_torch.MedicalVolume.from_torch(tr, np.eye(4), to_complex=True)
        assert back.dtype == torch.complex64 and back.shape == (3, 4, 5)
        np.testing.assert_array_equal(back.A.numpy(), arr)
    arr128 = arr.astype(np.complex128)
    back = dosma_tpu_torch.MedicalVolume.from_torch(
        dosma_tpu_torch.MedicalVolume(arr128, np.eye(4)).to_torch(view_as_real=True),
        np.eye(4), to_complex=True)
    assert back.dtype == torch.complex128
    np.testing.assert_array_equal(back.A.numpy(), arr128)


def test_from_torch_matches_jax():
    rs = np.random.RandomState(0)
    t = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    mt = dosma_tpu_torch.MedicalVolume.from_torch(t, torch.eye(4))
    mj = dosma_tpu.MedicalVolume.from_torch(t, torch.eye(4))
    assert mt.A.data_ptr() == t.data_ptr()  # on its own device, without a copy
    np.testing.assert_array_equal(mt.A.numpy(), np.asarray(mj.A))
    np.testing.assert_array_equal(mt.affine, mj.affine)
    real_view = torch.tensor(rs.rand(3, 4, 5, 2).astype(np.float32))
    ct = dosma_tpu_torch.MedicalVolume.from_torch(real_view, np.eye(4), to_complex=True)
    cj = dosma_tpu.MedicalVolume.from_torch(real_view, np.eye(4), to_complex=True)
    np.testing.assert_array_equal(ct.A.numpy(), np.asarray(cj.A))
    passthrough = torch.complex(torch.ones(2, 3, 4), torch.zeros(2, 3, 4))
    cp = dosma_tpu_torch.MedicalVolume.from_torch(passthrough, np.eye(4), to_complex=True)
    assert cp.dtype == torch.complex64 and cp.shape == (2, 3, 4)
    for bad, kw in ((torch.ones(3, 4), {}), (torch.ones(3, 4, 5), {"to_complex": True}),
                    (torch.ones(3, 4, 5, 3), {"to_complex": True}),
                    (torch.ones(3, 4, 5, 2, dtype=torch.int32), {"to_complex": True})):
        with pytest.raises(ValueError):
            dosma_tpu_torch.MedicalVolume.from_torch(bad, np.eye(4), **kw)
    with pytest.raises(RuntimeError, match="cpu"):
        dosma_tpu_torch.MedicalVolume.from_torch(t, torch.eye(4, device="meta"))
    full = dosma_tpu_torch.MedicalVolume(rs.rand(4, 5, 6), np.eye(4))
    again = dosma_tpu_torch.MedicalVolume.from_torch(full.to_torch(), full.affine)
    np.testing.assert_array_equal(again.A.numpy(), full.A)


def test_mmap_nifti_copy_on_write(tmp_path):
    """A write to a copy-on-write memory map (an item, an in-place operator)
    leaves the file as it was and ``is_mmap`` false, as ``dosma_tpu`` does."""
    from dosma_tpu.core.io.nifti_io import NiftiReader as JNiftiReader
    from dosma_tpu_torch.core.io.nifti_io import NiftiReader, NiftiWriter

    arr = np.random.RandomState(0).rand(6, 7, 8).astype(np.float32)
    path = str(tmp_path / "v.nii")  # uncompressed: memory-mappable
    NiftiWriter().save(dosma_tpu_torch.MedicalVolume(arr, np.eye(4)), path)
    for write in (lambda v: v.__setitem__((slice(0, 1),) * 3, 5.0), lambda v: v.__iadd__(1.0)):
        mv, mj = NiftiReader().load(path, mmap=True), JNiftiReader().load(path, mmap=True)
        assert mv.is_mmap and mj.is_mmap
        write(mv)
        write(mj)
        assert mv.is_mmap == mj.is_mmap is False
        np.testing.assert_array_equal(mv.A, np.asarray(mj.A))
        assert float(NiftiReader().load(path).A[0, 0, 0]) == arr[0, 0, 0]  # the file kept
    np.testing.assert_array_equal(mv.A, arr + np.float32(1.0))


def test_mmap_numpy_materialize(tmp_path):
    path = str(tmp_path / "arr.npy")
    np.save(path, np.random.RandomState(0).rand(4, 5, 6))
    mv = dosma_tpu_torch.MedicalVolume(np.load(path, mmap_mode="r"), np.eye(4))
    mj = dosma_tpu.MedicalVolume(np.load(path, mmap_mode="r"), np.eye(4))
    assert mv.is_mmap and mj.is_mmap
    assert mv.materialize() is mv and not mv.is_mmap
    np.testing.assert_array_equal(mv.A, np.asarray(mj.materialize().A))
    assert not dosma_tpu_torch.MedicalVolume(torch.zeros(2, 2, 2), np.eye(4)).is_mmap


# ----------------------------------------------------------------------
# Device (tests/core/test_device.py:12-85)
# ----------------------------------------------------------------------
def test_device_at_and_with_set_the_default_device():
    from dosma_tpu_torch.core.device import cpu_device, get_default_device, set_default_device

    set_default_device(None)  # the first card; this machine may have none
    try:
        with cpu_device.at() as dev:
            assert dev == cpu_device and get_default_device() == cpu_device
            mt = dosma_tpu_torch.MedicalVolume(np.ones((2, 2, 2)), np.eye(4)).device_put()
            assert mt.A.device.type == "cpu"
        target = Device("cpu")
        with target as dev:
            assert dev is target and get_default_device() == cpu_device
            with Device(-1):
                assert get_default_device() == cpu_device
            assert get_default_device() == cpu_device
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                get_default_device()
    finally:
        set_default_device("cpu")


def test_device_torch_interop_id_and_xp():
    from dosma_tpu_torch.core.device import cpu_device, get_array_module

    assert Device(torch.device("cpu")) == cpu_device == Device(torch.device("cpu", 0))
    assert cpu_device == torch.device("cpu") and cpu_device == torch.device("cpu", 0)
    assert cpu_device.ptdevice == torch.device("cpu") == cpu_device.to_torch()
    assert Device(cpu_device.ptdevice) == cpu_device
    assert cpu_device.id == cpu_device.index == -1 == dosma_tpu.cpu_device.id
    assert cpu_device.xp is np
    with pytest.raises((ValueError, RuntimeError)):
        Device("xla")
    arr = np.zeros((2, 2, 2))
    assert get_array_module(arr) is np is dosma_tpu.get_array_module(arr)
    assert get_array_module(torch.zeros(2)) is torch
    assert get_array_module(dosma_tpu_torch.MedicalVolume(arr, np.eye(4))) is np
    assert get_array_module(dosma_tpu_torch.MedicalVolume(torch.zeros(2, 2, 2), np.eye(4))) is torch
    assert dosma_tpu_torch.get_array_module is get_array_module
