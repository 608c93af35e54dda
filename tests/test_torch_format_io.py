"""The port's format dispatch (``read``/``write``/``load``/``save``,
``get_reader``/``get_writer``, ``generic_load``, path conventions) against
the JAX package's, on the same files: whatever one package writes, the
other reads to the same pixels and affine."""

import numpy as np
import pytest

import dosma_tpu
import dosma_tpu_torch as dt
from dosma_tpu.core.io import format_io_utils as jfio
from dosma_tpu_torch.core.io import format_io_utils as tfio
from tests.util import write_dicom_series


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


def _arrays():
    rs = np.random.RandomState(0)
    affine = dt.to_affine(dt.SAGITTAL, spacing=(0.5, 0.6, 2.0), origin=(3, -4, 7))
    return (rs.rand(6, 7, 3).astype(np.float32), affine)


def _same(vt, vj):
    assert vt.A.dtype == np.asarray(vj.A).dtype
    np.testing.assert_array_equal(np.asarray(vt.A), np.asarray(vj.A))
    np.testing.assert_array_equal(vt.affine, vj.affine)


def test_package_names_are_the_dispatch_functions():
    assert dt.read is tfio.read and dt.load is tfio.read
    assert dt.write is tfio.write and dt.save is tfio.write
    assert dt.generic_load is tfio.generic_load
    assert isinstance(dt.get_reader(dt.ImageDataFormat.nifti), dt.NiftiReader)
    assert isinstance(dt.get_writer(dt.ImageDataFormat.nifti), dt.NiftiWriter)
    assert isinstance(dt.get_reader(dt.ImageDataFormat.dicom), dt.DicomReader)
    assert isinstance(dt.get_writer(dt.ImageDataFormat.dicom), dt.DicomWriter)


@pytest.mark.parametrize("path", ["/x/series", "/x/series.nii.gz", "/x/a.nii", "b.dcm",
                                  "rel/dir"])
def test_path_conventions_match_jax(path):
    assert tfio.get_filepath_variations(path) == jfio.get_filepath_variations(path)
    fmt_t = dt.ImageDataFormat.get_image_data_format(path)
    fmt_j = dosma_tpu.ImageDataFormat.get_image_data_format(path)
    assert fmt_t.name == fmt_j.name
    for t_fmt, j_fmt in zip(dt.ImageDataFormat, dosma_tpu.ImageDataFormat):
        assert t_fmt.is_filetype(path) == j_fmt.is_filetype(path)
        assert (tfio.convert_image_data_format(path, t_fmt)
                == jfio.convert_image_data_format(path, j_fmt))


@pytest.mark.parametrize("name", ["v.nii.gz", "v.nii"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_nifti_written_by_one_read_by_both(tmp_path, name, writer):
    arr, affine = _arrays()
    path = str(tmp_path / name)
    if writer == "port":
        dt.write(dt.MedicalVolume(arr, affine), path)
    else:
        dosma_tpu.write(dosma_tpu.MedicalVolume(arr, affine), path)
    _same(dt.read(path), dosma_tpu.read(path))
    _same(dt.NiftiReader().load(path), dosma_tpu.NiftiReader().load(path))


def test_dicom_dispatch_and_kwargs_split(tmp_path):
    src = str(tmp_path / "dcm")
    write_dicom_series(src, shape=(8, 8, 2), n_echos=2)
    kw = dict(num_workers=0, group_by="EchoNumbers", sort_by="InstanceNumber")
    vts, vjs = dt.read(src, **kw), dosma_tpu.read(src, **kw)
    assert len(vts) == len(vjs) == 2
    for vt, vj in zip(vts, vjs):
        _same(vt, vj)
    dt.save(vts[1], str(tmp_path / "out"), data_format=dt.ImageDataFormat.dicom)
    _same(dosma_tpu.read(str(tmp_path / "out"))[0], vjs[1])


def test_save_volume_formats(tmp_path):
    arr, affine = _arrays()
    mv = dt.MedicalVolume(arr, affine)
    mv.save_volume(str(tmp_path / "default.nii.gz"))  # the preference data/format: nifti
    _same(dosma_tpu.read(str(tmp_path / "default.nii.gz")), dosma_tpu.MedicalVolume(arr, affine))
    # a tensor-backed volume is written from the host
    import torch

    dt.MedicalVolume(torch.from_numpy(arr), affine).save_volume(
        str(tmp_path / "t.nii.gz"), data_format=dt.ImageDataFormat.nifti)
    _same(dt.read(str(tmp_path / "t.nii.gz")), dosma_tpu.MedicalVolume(arr, affine))


def test_generic_load_probing_and_errors(tmp_path):
    arr, affine = _arrays()
    dt.write(dt.MedicalVolume(arr, affine), str(tmp_path / "scan.nii.gz"))
    _same(tfio.generic_load(str(tmp_path / "scan"), expected_num_volumes=1),
          jfio.generic_load(str(tmp_path / "scan"), expected_num_volumes=1))
    with pytest.raises(FileNotFoundError):
        tfio.generic_load(str(tmp_path / "nope"), expected_num_volumes=1)
    with pytest.raises(ValueError, match="Expected 2 volumes"):
        tfio.generic_load(str(tmp_path / "scan"), expected_num_volumes=2)
    (tmp_path / "scan").mkdir()
    with pytest.raises(ValueError, match="Ambiguous"):
        tfio.generic_load(str(tmp_path / "scan"))
    write_dicom_series(str(tmp_path / "series"), shape=(8, 8, 2), n_echos=2)
    vts = tfio.generic_load(str(tmp_path / "series"), expected_num_volumes=2)
    vjs = jfio.generic_load(str(tmp_path / "series"), expected_num_volumes=2)
    for vt, vj in zip(vts, vjs):
        _same(vt, vj)


def test_reader_writer_state_dicts():
    reader = dt.DicomReader()
    state = reader.state_dict()
    assert state == dosma_tpu.DicomReader().state_dict()
    state.update({"num_workers": 8, "group_by": None})
    again = dt.DicomReader().load_state_dict(state)
    assert again.num_workers == 8 and again.group_by is None
    with pytest.raises(ValueError):
        dt.DicomWriter().load_state_dict({"no_such_field": 1}, strict=True)
    assert dt.NiftiReader().state_dict() == {"mmap": False}


def test_host_helpers_match_jax(tmp_path):
    """natsort, pickle and xlsx helpers, the logger and the debug flag."""
    import zipfile

    import pandas as pd

    from dosma_tpu.utils import io_utils as jio_utils
    from dosma_tpu.utils import natsort as jnat
    from dosma_tpu_torch.utils import io_utils as tio_utils
    from dosma_tpu_torch.utils import natsort as tnat

    names = ["I10.dcm", "I2.dcm", "a1b10", "a1b9", "I1.dcm", "x", "10", 2, 1.5]
    assert tnat.natsorted(names[:7]) == jnat.natsorted(names[:7])
    assert tnat.index_natsorted(names[:7]) == jnat.index_natsorted(names[:7])
    keyed = [("EchoNumbers", 2), ("EchoNumbers", 10), ("EchoNumbers", 1)]
    assert tnat.natsorted(keyed, key=lambda t: t) == jnat.natsorted(keyed, key=lambda t: t)

    data = {"a": np.arange(3), "b": "text"}
    tio_utils.save_pik(str(tmp_path / "d" / "x.pik"), data)
    back = jio_utils.load_pik(str(tmp_path / "d" / "x.pik"))
    assert back["b"] == "text" and np.array_equal(back["a"], data["a"])

    df = pd.DataFrame({"Category": ["total", "l<1>"], "Mean": [1.5, np.nan], "# Voxels": [3, 0]})
    for tag, mod in (("port", tio_utils), ("jax", jio_utils)):
        mod.save_tables(str(tmp_path / f"{tag}.xlsx"), [df, df], ["one", "two"])
    with zipfile.ZipFile(tmp_path / "port.xlsx") as zt, zipfile.ZipFile(tmp_path / "jax.xlsx") as zj:
        assert zt.namelist() == zj.namelist()
        for name in zt.namelist():
            assert zt.read(name) == zj.read(name)

    logger = dt.setup_logger(output=str(tmp_path / "log.txt"), name="dosma_tpu_torch_test")
    logger.info("hello")
    assert "hello" in (tmp_path / "log.txt").read_text()
    before = dt.debug()
    try:
        assert dt.debug(True) is True
        with pytest.raises(ValueError):
            dt.debug("yes")
    finally:
        dt.debug(before)
