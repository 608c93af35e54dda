"""The port's ``ScanIOMixin`` (``dosma_tpu_torch/scan_sequences/scan_io.py``)
on a minimal mock scan, as ``tests/scan_sequences/test_scan_io.py`` holds
``dosma_tpu``'s: construction from DICOM files (on the host and through
``load_to_device``), ``from_dict``'s force/warn rules, the choice of
serializable attributes, save/load round trips, the legacy keys, the
failures, and the reference header that survives a header-less reload. The
volumes read are held against ``dosma_tpu``'s reading of the same files:
pixels and affines exactly.
"""

import os
import warnings

import numpy as np
import pytest

import torch

import dosma_tpu_torch as dt
from dosma_tpu.scan_sequences.scan_io import ScanIOMixin as JScanIOMixin
from dosma_tpu_torch.core.io.dicom.dataset import Dataset
from dosma_tpu_torch.scan_sequences.scan_io import ScanIOMixin
from tests.util import write_dicom_series


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    with dt.default_device("cpu"):
        yield


class MockScan(ScanIOMixin):
    NAME = "mock-scan-io"
    __DEFAULT_SPLIT_BY__ = "EchoNumbers"

    def __init__(self, volumes, foo="foo", bar="bar"):
        self.volumes = volumes
        self._from_file_args = {}
        self.foo = foo
        self._bar = bar
        # Must NOT be serialized:
        self.temp_path = "some/path"
        self.__some_attr__ = 1234
        self._header_attr = Dataset()

    @property
    def some_property(self):
        return "new/path"


@pytest.fixture()
def dicom_dir(tmp_path):
    d = os.path.join(str(tmp_path), "src")
    arr = write_dicom_series(d, shape=(8, 8, 3), n_echos=1)
    return d, arr


class TestFromDicom:
    def test_from_dir_records_source(self, dicom_dir):
        d, arr = dicom_dir
        scan = MockScan.from_dicom(d, foo="foofoo", bar="barbar")
        assert len(scan.volumes) == 1
        assert np.all(np.asarray(scan.volumes[0].volume) == arr[..., 0])
        assert scan.foo == "foofoo"
        assert scan._bar == "barbar"
        assert scan._from_file_args == {
            "dir_or_files": os.path.abspath(d),
            "ignore_ext": False,
            "group_by": "EchoNumbers",
            "_type": "dicom",
        }

    def test_from_file_list(self, dicom_dir):
        d, arr = dicom_dir
        files = sorted(os.path.join(d, f) for f in os.listdir(d))
        scan = MockScan.from_dicom(files)
        assert len(scan.volumes) == 1
        assert scan._from_file_args["dir_or_files"] == [os.path.abspath(f) for f in files]


class JMockScan(JScanIOMixin):
    NAME = "mock-scan-io"
    __DEFAULT_SPLIT_BY__ = "EchoNumbers"

    def __init__(self, volumes):
        self.volumes = volumes
        self._from_file_args = {}


@pytest.mark.parametrize("to_device", [None, "cpu", True])
def test_from_dicom_matches_jax(tmp_path, to_device):
    """Two echoes read by both packages: equal pixels and affines. With
    ``to_device`` the volumes are tensors on that device (``True``: the
    default device, here the CPU) and uint16 arrives as int32."""
    d = os.path.join(str(tmp_path), "src")
    write_dicom_series(d, shape=(10, 12, 4), n_echos=2, plane="sagittal")
    want = JMockScan.from_dicom(d)
    got = MockScan.from_dicom(d, to_device=to_device)
    assert len(got.volumes) == len(want.volumes) == 2
    for g, w in zip(got.volumes, want.volumes):
        if to_device is None:
            assert isinstance(g.volume, np.ndarray) and g.volume.dtype == np.uint16
            np.testing.assert_array_equal(g.volume, np.asarray(w.volume))
        else:
            assert isinstance(g.volume, torch.Tensor) and g.volume.dtype == torch.int32
            np.testing.assert_array_equal(g.volume.numpy(), np.asarray(w.volume))
        np.testing.assert_array_equal(g.affine, w.affine)
        assert g.headers().shape == w.headers().shape
    assert got._from_file_args == want._from_file_args


class TestFromDict:
    def test_roundtrip(self, dicom_dir):
        d, _ = dicom_dir
        scan1 = MockScan.from_dicom(d)
        scan2 = MockScan.from_dict(scan1.__dict__)
        assert scan1.__dict__.keys() == scan2.__dict__.keys()
        for k, v in scan1.__dict__.items():
            got = scan2.__dict__[k]
            if k == "volumes":
                assert all(a.is_identical(b) for a, b in zip(v, got))
            else:
                assert got == v

    def test_unknown_attr_warns_unless_forced(self, dicom_dir):
        d, _ = dicom_dir
        scan1 = MockScan.from_dicom(d)
        data = dict(scan1.__dict__)
        data["extra_bool_field"] = True

        with pytest.warns(UserWarning, match="extra_bool_field"):
            scan2 = MockScan.from_dict(data)
        assert not hasattr(scan2, "extra_bool_field")

        scan3 = MockScan.from_dict(data, force=True)
        assert scan3.extra_bool_field is True


class TestSerializableVariables:
    def test_selection_rules(self, dicom_dir):
        d, _ = dicom_dir
        scan = MockScan.from_dicom(d)
        attrs = scan.__serializable_variables__()
        for required in ("foo", "_bar", "volumes", "_from_file_args"):
            assert required in attrs
        for excluded in ("temp_path", "__some_attr__", "_header_attr", "some_property"):
            assert excluded not in attrs


class TestSaveLoad:
    def test_save_load_roundtrip(self, dicom_dir, tmp_path):
        d, _ = dicom_dir
        scan = MockScan.from_dicom(d, foo="foofoo", bar="barbar")
        save_dir = os.path.join(str(tmp_path), "saved")

        save_path = scan.save(save_dir, save_custom=True)
        assert os.path.isfile(save_path)

        # Load by file and by directory.
        for target in (save_path, save_dir):
            loaded = MockScan.load(target)
            assert loaded.volumes[0].is_identical(scan.volumes[0])
            assert loaded.foo == "foofoo"
            assert loaded._bar == "barbar"

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            MockScan.load(os.path.join(str(tmp_path), "nope.data"))

    def test_reload_from_source_when_volumes_absent(self, dicom_dir):
        d, _ = dicom_dir
        scan = MockScan.from_dicom(d, foo="foofoo")
        data = dict(scan.__dict__)
        data.pop("volumes")

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            loaded = MockScan.load(data)
        assert loaded.volumes[0].is_identical(scan.volumes[0])
        assert loaded.foo == "foofoo"

    def test_legacy_dicom_path_keys(self, dicom_dir):
        """Dicts written by old versions carry dicom_path/split_by instead of
        _from_file_args (ref ``scan_io.py:211-234``)."""
        d, _ = dicom_dir
        scan = MockScan.from_dicom(d)
        data = dict(scan.__dict__)
        data.pop("volumes")
        data.pop("_from_file_args")
        data.update({"dicom_path": d, "ignore_ext": False, "split_by": "EchoNumbers"})

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            loaded = MockScan.load(data)
        assert loaded.volumes[0].is_identical(scan.volumes[0])

    def test_insufficient_data_raises(self, dicom_dir):
        d, _ = dicom_dir
        scan = MockScan.from_dicom(d)
        data = dict(scan.__dict__)
        data.pop("volumes")
        data.pop("_from_file_args")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(ValueError):
                MockScan.load(data)


class TestRefDicomPersistence:
    def test_metadata_survives_headerless_reload(self, tmp_path):
        """save_custom=True externalizes volumes to NIfTI (no DICOM headers);
        header-derived metadata (acquisition params, private tags) must still
        resolve after reload via the persisted ``_ref_dicom_state`` snapshot.
        The reference loses this metadata (its ``ref_dicom`` is a property
        over reloaded, header-less volumes)."""
        from dosma_tpu_torch.core.io.dicom import Tag
        from dosma_tpu_torch.core.io.format_io import ImageDataFormat
        from dosma_tpu_torch.scan_sequences.mri.qdess import QDess

        d = os.path.join(str(tmp_path), "qdess_src")
        write_dicom_series(
            d, shape=(8, 8, 2), n_echos=2,
            extra={Tag(0x0019, 0x10B6): 3132.0, Tag(0x0019, 0x10B7): 1560.0},
        )
        scan = QDess.from_dicom(d)
        save = os.path.join(str(tmp_path), "saved")
        scan.save(save, save_custom=True, image_data_format=ImageDataFormat.nifti)

        loaded = QDess.load(save)
        # Volumes reloaded from NIfTI — no per-slice headers...
        assert loaded.volumes[0].headers() is None
        # ...yet the reference header (and its private tags) still resolves.
        assert loaded.ref_dicom is not None
        assert float(loaded.get_metadata(loaded.__GL_AREA_TAG__)) == 3132.0
        assert float(loaded.get_metadata(loaded.__TG_TAG__)) == 1560.0
        # Pixel bytes were stripped from the snapshot.
        assert "PixelData" not in loaded.ref_dicom


class TestNestedPlaceholders:
    def test_placeholder_inside_placeholder_container(self, dicom_dir, tmp_path):
        """Placeholders nested inside a placeholder-wrapped container must
        resolve (the reference's interregistered-subvolumes dict shape)."""
        from dosma_tpu_torch.core.med_volume import MedicalVolume

        d, _ = dicom_dir
        scan = MockScan.from_dicom(d)
        vol = scan.volumes[0]
        p = os.path.join(str(tmp_path), "vol.nii.gz")
        vol.save_volume(p)

        data = {
            "__dtype__": dict,
            "__value__": {0: {"__dtype__": MedicalVolume, "__value__": p}},
        }
        out = MockScan.load_custom_data(data)
        assert isinstance(out, dict)
        assert isinstance(out[0], MedicalVolume)
        assert out[0].is_identical(vol) or np.allclose(np.asarray(out[0].A), np.asarray(vol.A))
