"""The port's ``DicomReader`` / ``DicomWriter`` against the JAX package's.

Series are written by ``tests.util.write_dicom_series`` (``dosma_tpu``'s
writer) and read by both readers: the same number of volumes in the same
order, bit-equal pixels of the same dtype, equal affines, header layouts
and metadata, serial (pure-Python parse) and threaded (the port's native
batch reader, built here with g++). Series the port writes are read by
``dosma_tpu`` and must equal what ``dosma_tpu``'s own writer gives.
"""

import os

import numpy as np
import pytest

import dosma_tpu
import dosma_tpu_torch
from dosma_tpu.core.io import dicom_io as jio
from dosma_tpu_torch.core.io import dicom_io as tio
from tests.util import write_dicom_series


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_KEYS = ("EchoNumbers", "EchoTime", "InstanceNumber", "RepetitionTime", "SeriesInstanceUID")


def assert_same_volumes(vts, vjs):
    """Port volumes ``vts`` equal the JAX package's ``vjs``."""
    assert len(vts) == len(vjs)
    for vt, vj in zip(vts, vjs):
        assert isinstance(vt.A, np.ndarray)
        assert vt.A.dtype == np.asarray(vj.A).dtype
        np.testing.assert_array_equal(vt.A, np.asarray(vj.A))
        np.testing.assert_array_equal(vt.affine, vj.affine)
        assert vt.orientation == vj.orientation
        assert vt.headers().shape == vj.headers().shape
        for ht, hj in zip(vt.headers(flatten=True), vj.headers(flatten=True)):
            for key in _KEYS:
                assert ht.get(key) == hj.get(key), key
        for key in _KEYS:
            assert vt.get_metadata(key) == vj.get_metadata(key)


# name: (write_dicom_series kwargs, reader kwargs, load kwargs)
_READS = {
    "axial_echoes_serial": (dict(shape=(12, 10, 4), n_echos=3), dict(num_workers=0), {}),
    "axial_echoes_threaded": (dict(shape=(12, 10, 4), n_echos=3), dict(num_workers=4), {}),
    "sagittal_serial": (dict(shape=(10, 9, 5), n_echos=2, plane="sagittal"),
                        dict(num_workers=0), {}),
    "sagittal_threaded": (dict(shape=(10, 9, 5), n_echos=2, plane="sagittal"),
                          dict(num_workers=2), {}),
    "spacing_and_origin": (dict(shape=(8, 8, 3), n_echos=1, spacing=(0.5, 0.7, 1.2),
                                origin=(5, -3, 2)), {}, {}),
    "group_by_echo_time": (dict(shape=(8, 8, 3), n_echos=2), {}, dict(group_by="EchoTime")),
    "no_group_by": (dict(shape=(8, 8, 3), n_echos=2), {}, dict(group_by=None)),
    "sort_by_instance": (dict(shape=(8, 8, 4), n_echos=2), {},
                         dict(sort_by=("EchoNumbers", "InstanceNumber"))),
    "ctor_group_and_sort": (dict(shape=(8, 8, 3), n_echos=2),
                            dict(group_by="EchoNumbers", sort_by="InstanceNumber"), {}),
    "one_slice": (dict(shape=(8, 6, 1), n_echos=2), {}, {}),
}


@pytest.mark.parametrize("name", list(_READS))
def test_load_matches_jax(tmp_path, name):
    series, reader_kw, load_kw = _READS[name]
    write_dicom_series(str(tmp_path), **series)
    vjs = jio.DicomReader(**reader_kw).load(str(tmp_path), **load_kw)
    vts = tio.DicomReader(**reader_kw).load(str(tmp_path), **load_kw)
    assert_same_volumes(vts, vjs)


@pytest.mark.parametrize("num_workers", [0, 3])
def test_iter_groups_matches_load_and_jax(tmp_path, num_workers):
    write_dicom_series(str(tmp_path), shape=(10, 8, 3), n_echos=3)
    reader = tio.DicomReader(num_workers=num_workers)
    groups = list(reader.iter_groups(str(tmp_path)))
    assert_same_volumes(groups, jio.DicomReader().load(str(tmp_path)))
    assert_same_volumes(groups, list(jio.DicomReader().iter_groups(str(tmp_path))))


@pytest.mark.parametrize("source", ["files", "bytes"])
def test_load_files_and_bytes(tmp_path, source):
    write_dicom_series(str(tmp_path), shape=(8, 8, 3), n_echos=2)
    files = sorted(os.path.join(tmp_path, f) for f in os.listdir(tmp_path) if f.endswith(".dcm"))
    arg = files if source == "files" else [open(f, "rb").read() for f in files]
    assert_same_volumes(tio.DicomReader().load(arg), jio.DicomReader().load(arg))


def test_multi_tag_group_by(tmp_path):
    from dosma_tpu.core.io.dicom.dataset import Tag

    write_dicom_series(str(tmp_path / "a"), shape=(8, 8, 2), n_echos=2,
                       extra={Tag(0x0020, 0x0011): 5})
    write_dicom_series(str(tmp_path / "b"), shape=(8, 8, 2), n_echos=2,
                       extra={Tag(0x0020, 0x0011): 7})
    files = [os.path.join(r, f) for r, _d, fs in os.walk(tmp_path) for f in fs]
    kw = dict(group_by=("SeriesNumber", "EchoNumbers"))
    vts = tio.DicomReader().load(files, **kw)
    assert len(vts) == 4
    assert_same_volumes(vts, jio.DicomReader().load(files, **kw))


def test_group_by_missing_tag_raises(tmp_path):
    write_dicom_series(str(tmp_path), shape=(8, 8, 2), n_echos=1)
    with pytest.raises(KeyError):
        tio.DicomReader().load(str(tmp_path), group_by="TemporalPositionIdentifier")


@pytest.mark.parametrize("transfer_syntax", [None, "1.2.840.10008.1.2.5"], ids=["plain", "rle"])
def test_multiframe_written_by_jax_read_by_both(tmp_path, transfer_syntax):
    write_dicom_series(str(tmp_path / "src"), shape=(10, 8, 3), n_echos=2)
    vols = jio.DicomReader().load(str(tmp_path / "src"))
    v4 = dosma_tpu.core.numpy_routines.stack(vols, axis=-1)
    jio.DicomWriter(multi_frame=True).save(v4, str(tmp_path / "mf"),
                                           transfer_syntax=transfer_syntax)
    for loader in ("load", "iter_groups"):
        vts = list(getattr(tio.DicomReader(), loader)(str(tmp_path / "mf")))
        vjs = list(getattr(jio.DicomReader(), loader)(str(tmp_path / "mf")))
        assert_same_volumes(vts, vjs)


# name: (series kwargs, stack the echoes into 4D, writer kwargs)
_WRITES = {
    "per_slice": (dict(shape=(12, 10, 4), n_echos=1), False, {}),
    "after_reformat": (dict(shape=(12, 10, 4), n_echos=1), "reformat", {}),
    "four_d_echoes": (dict(shape=(12, 10, 3), n_echos=2), True, {}),
    "sort_by_instance": (dict(shape=(12, 10, 4), n_echos=1), False, dict(sort_by="InstanceNumber")),
    "fname_fmt": (dict(shape=(8, 8, 3), n_echos=1), False, dict(fname_fmt="slice%03d.dcm")),
    "threaded": (dict(shape=(12, 10, 4), n_echos=1), False, dict(num_workers=3)),
    "rle": (dict(shape=(12, 10, 4), n_echos=1), False,
            dict(transfer_syntax="1.2.840.10008.1.2.5")),
    "multi_frame": (dict(shape=(12, 10, 3), n_echos=2), True, dict(multi_frame=True)),
}


def _volume_to_write(pkg, io_mod, src, stack):
    vols = io_mod.DicomReader().load(src)
    if stack is True:
        return pkg.core.numpy_routines.stack(vols, axis=-1)
    if stack == "reformat":
        return vols[0].reformat(vols[0].orientation[::-1])
    return vols[0]


@pytest.mark.parametrize("name", list(_WRITES))
def test_jax_reads_what_the_port_writes(tmp_path, name):
    series, stack, writer_kw = _WRITES[name]
    src = str(tmp_path / "src")
    write_dicom_series(src, **series)
    tio.DicomWriter(**writer_kw).save(
        _volume_to_write(dosma_tpu_torch, tio, src, stack), str(tmp_path / "port"))
    jio.DicomWriter(**writer_kw).save(
        _volume_to_write(dosma_tpu, jio, src, stack), str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    back_port = jio.DicomReader().load(str(tmp_path / "port"))
    back_jax = jio.DicomReader().load(str(tmp_path / "jax"))
    assert len(back_port) == len(back_jax)
    for a, b in zip(back_port, back_jax):
        np.testing.assert_array_equal(np.asarray(a.A), np.asarray(b.A))
        np.testing.assert_array_equal(a.affine, b.affine)
        assert a.get_metadata("EchoNumbers") == b.get_metadata("EchoNumbers")


@pytest.mark.parametrize("dtype", ["float32", "float64", "int16", "int32", "uint8", "uint16"])
def test_writer_dtype_coercion_matches_jax(tmp_path, dtype):
    src = str(tmp_path / "src")
    write_dicom_series(src, shape=(8, 8, 2), n_echos=1)
    outs = {}
    for tag, io_mod in (("jax", jio), ("port", tio)):
        vol = io_mod.DicomReader().load(src)[0]
        vol.volume = (np.asarray(vol.A) % 100).astype(dtype)
        io_mod.DicomWriter().save(vol, str(tmp_path / tag))
        outs[tag] = jio.DicomReader().load(str(tmp_path / tag))[0]
    assert outs["port"].A.dtype == outs["jax"].A.dtype
    np.testing.assert_array_equal(outs["port"].A, outs["jax"].A)


def test_writer_refusals_match_jax(tmp_path):
    mv = dosma_tpu_torch.MedicalVolume(np.zeros((4, 4, 2)), np.eye(4))
    with pytest.raises(ValueError):
        tio.DicomWriter().save(mv, str(tmp_path / "out"))
    src = str(tmp_path / "src")
    write_dicom_series(src, shape=(8, 8, 2), n_echos=1)
    vol = tio.DicomReader().load(src)[0]
    vol.volume = np.full(vol.shape, 1e6)  # beyond every 16-bit type
    with pytest.raises(ValueError):
        tio.DicomWriter().save(vol, str(tmp_path / "big"))


def test_to_ras_affine_and_fallbacks_match_jax(tmp_path):
    write_dicom_series(str(tmp_path), shape=(8, 8, 3), n_echos=1, plane="sagittal",
                       origin=(1.5, -2, 3))
    files = sorted(os.path.join(tmp_path, f) for f in os.listdir(tmp_path))
    from dosma_tpu.core.io.dicom import read_dicom as j_read
    from dosma_tpu_torch.core.io.dicom import read_dicom as t_read

    hj, ht = [j_read(f) for f in files], [t_read(f) for f in files]
    np.testing.assert_array_equal(tio.to_RAS_affine(ht), jio.to_RAS_affine(hj))
    np.testing.assert_array_equal(tio.to_RAS_affine(ht[:1]), jio.to_RAS_affine(hj[:1]))
    for h in (hj[0], ht[0]):
        del h["ImageOrientationPatient"]
        h.PatientOrientation = ["P", "F"]
    np.testing.assert_array_equal(tio.to_RAS_affine(ht[:1]), jio.to_RAS_affine(hj[:1]))
    np.testing.assert_array_equal(tio.to_RAS_affine(ht[:1], default_ornt=("SI", "AP")),
                                  jio.to_RAS_affine(hj[:1], default_ornt=("SI", "AP")))


def test_get_and_set_metadata_match_jax(tmp_path):
    write_dicom_series(str(tmp_path), shape=(8, 8, 2), n_echos=1)
    vt = tio.DicomReader().load(str(tmp_path))[0]
    vj = jio.DicomReader().load(str(tmp_path))[0]
    for v in (vt, vj):
        v.set_metadata("EchoTime", 12.5)
        v.set_metadata("SliceThickness", 2.0)
        with pytest.raises(KeyError):
            v.set_metadata("TriggerTime", 3.0)
        v.set_metadata("TriggerTime", 3.0, force=True)
    for key, dtype in (("EchoTime", None), ("TriggerTime", float), ("SliceThickness", str)):
        assert vt.get_metadata(key, dtype) == vj.get_metadata(key, dtype)
    assert vt.get_metadata("FlipAngle", default=None) == vj.get_metadata("FlipAngle", default=None)
    assert vt.get_metadata("NotAKeyword", default=7) == 7
    with pytest.raises(KeyError):
        vt.get_metadata("NotAKeyword")
    bare = dosma_tpu_torch.MedicalVolume(np.zeros((2, 2, 2)), np.eye(4))
    with pytest.raises(RuntimeError):
        bare.get_metadata("EchoTime")
    with pytest.raises(ValueError):
        bare.set_metadata("EchoTime", 1.0)
    with pytest.warns(UserWarning):
        bare.set_metadata("EchoTime", 1.0, force=True)
    assert bare.get_metadata("EchoTime") == 1.0


def test_native_batch_reader_is_the_ports_own_build(tmp_path):
    """The threaded read goes through the library built from the port's
    copy of the C++ source, never the JAX package's prebuilt one."""
    from dosma_tpu_torch.core.io import _native

    lib = _native._load()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path).endswith(os.path.join("dosma_tpu_torch", "_build"))
    assert os.path.basename(path).startswith("libdosma_io-")
    write_dicom_series(str(tmp_path), shape=(8, 8, 2), n_echos=1)
    files = sorted(os.path.join(tmp_path, f) for f in os.listdir(tmp_path))
    assert _native.read_files_bytes(files) == [open(f, "rb").read() for f in files]


@pytest.mark.parametrize("source", ["read", "built"])
def test_header_deepcopy_is_independent_and_matches_jax(tmp_path, source):
    """A deep copy of a header equals the original element by element (as
    the JAX package's copy does) and shares nothing mutable with it: list
    values, nested sequences and the file meta are copied, not aliased."""
    import copy

    from dosma_tpu.core.io.dicom import Dataset as JDataset
    from dosma_tpu_torch.core.io.dicom import Dataset as TDataset

    if source == "read":
        write_dicom_series(str(tmp_path), shape=(8, 8, 2), n_echos=1)
        ht = tio.DicomReader().load(str(tmp_path))[0].headers(flatten=True)[0]
        hj = jio.DicomReader().load(str(tmp_path))[0].headers(flatten=True)[0]
    else:
        ht, hj = TDataset(), JDataset()
        for ds in (ht, hj):
            ds.EchoTime, ds.EchoNumbers, ds.Modality = 8.0, 2, "MR"
            ds.PixelSpacing = [0.5, 0.5]
            ds.ImagePositionPatient = [1.0, 2.0, 3.0]
            ds.PixelData = b"\x00\x01" * 8
            ds.add_new(0x00081140, "SQ", [type(ds)()])
    ct, cj = copy.deepcopy(ht), copy.deepcopy(hj)
    assert ct == ht
    assert ([(int(e.tag), e.VR, repr(e.value)) for e in ct]
            == [(int(e.tag), e.VR, repr(e.value)) for e in cj])
    for e in ct:
        orig = ht[e.tag]
        assert e is not orig and type(e.tag) is type(orig.tag)
        if isinstance(e.value, (list, TDataset)):
            assert e.value is not orig.value
    if ht.file_meta is not None:
        assert ct.file_meta == ht.file_meta and ct.file_meta is not ht.file_meta
    ct.ImagePositionPatient[0] = -9.0
    assert ht.ImagePositionPatient[0] != -9.0
