"""I/O dispatch utilities (counterpart of ``dosma_tpu/core/io/format_io_utils.py``;
a re-design of DOSMA's ``dosma/core/io/format_io_utils.py``).

``read``/``write`` by inferred or explicit format (ref ``:158-224``),
reader/writer registries (ref ``:23-48``), filename-convention conversion
between dicom directories and ``.nii.gz`` (ref ``:51-85``), and
``generic_load`` probing all format variants (ref ``:103-155``).
"""

from __future__ import annotations

import os
from dosma_tpu_torch.core.io.dicom_io import DicomReader, DicomWriter
from dosma_tpu_torch.core.io.format_io import DataReader, DataWriter, ImageDataFormat
from dosma_tpu_torch.core.io.nifti_io import NiftiReader, NiftiWriter
from dosma_tpu_torch.core.med_volume import MedicalVolume

__all__ = [
    "read",
    "write",
    "get_reader",
    "get_writer",
    "get_filepath_variations",
    "convert_image_data_format",
    "generic_load",
]

_READERS = {ImageDataFormat.dicom: DicomReader, ImageDataFormat.nifti: NiftiReader}
_WRITERS = {ImageDataFormat.dicom: DicomWriter, ImageDataFormat.nifti: NiftiWriter}


def get_reader(data_format: ImageDataFormat) -> DataReader:
    return _READERS[data_format]()


def get_writer(data_format: ImageDataFormat) -> DataWriter:
    return _WRITERS[data_format]()


def convert_image_data_format(file_or_dir_path, new_data_format: ImageDataFormat) -> str:
    """Rename path to the naming convention of ``new_data_format``."""
    current_format = ImageDataFormat.get_image_data_format(file_or_dir_path)
    if current_format == new_data_format:
        return str(file_or_dir_path)

    dirname = os.path.dirname(file_or_dir_path)
    basename = os.path.basename(file_or_dir_path)
    if current_format == ImageDataFormat.dicom and new_data_format == ImageDataFormat.nifti:
        return os.path.join(dirname, f"{basename}.nii.gz")
    if current_format == ImageDataFormat.nifti and new_data_format == ImageDataFormat.dicom:
        return os.path.join(dirname, basename.split(".", 1)[0])
    raise NotImplementedError(f"{current_format.name} -> {new_data_format.name} not implemented")


def get_filepath_variations(file_or_dir_path):
    return [convert_image_data_format(file_or_dir_path, fmt) for fmt in ImageDataFormat]


def generic_load(file_or_dir_path, expected_num_volumes: int = None):
    """Load volume(s) probing all data-format path variants."""
    possible_filepaths = get_filepath_variations(file_or_dir_path)
    exist_path = None
    for fp in possible_filepaths:
        if os.path.exists(fp):
            if exist_path is not None:
                raise ValueError(
                    f"Ambiguous loading state - multiple possible files to load "
                    f"from {possible_filepaths}"
                )
            exist_path = fp
    if exist_path is None:
        raise FileNotFoundError(
            f"No file associated with basename {os.path.basename(file_or_dir_path)} found"
        )

    io_format = ImageDataFormat.get_image_data_format(exist_path)
    vols = get_reader(io_format).load(exist_path)

    if expected_num_volumes is None:
        return vols
    if not isinstance(vols, list):
        vols = [vols]
    if len(vols) != expected_num_volumes:
        raise ValueError(f"Expected {expected_num_volumes} volumes, got {len(vols)}")
    return vols[0] if len(vols) == 1 else vols


def read(path, data_format: ImageDataFormat = None, **kwargs):
    """Read MedicalVolume(s) from ``path``, inferring format if not given
    (ref ``format_io_utils.py:158-194``). Extra kwargs configure the reader."""
    if data_format is None:
        data_format = ImageDataFormat.get_image_data_format(str(path))
    reader_cls = _READERS[data_format]
    import inspect

    init_params = set(inspect.signature(reader_cls.__init__).parameters)
    init_kwargs = {k: v for k, v in kwargs.items() if k in init_params}
    load_kwargs = {k: v for k, v in kwargs.items() if k not in init_params}
    reader = reader_cls(**init_kwargs)
    return reader.load(path, **load_kwargs)


def write(volume: MedicalVolume, path, data_format: ImageDataFormat = None, **kwargs):
    """Write ``volume`` to ``path``, inferring format if not given
    (ref ``format_io_utils.py:195-224``)."""
    if data_format is None:
        data_format = ImageDataFormat.get_image_data_format(str(path))
    writer_cls = _WRITERS[data_format]
    import inspect

    init_params = set(inspect.signature(writer_cls.__init__).parameters)
    init_kwargs = {k: v for k, v in kwargs.items() if k in init_params}
    save_kwargs = {k: v for k, v in kwargs.items() if k not in init_params}
    writer = writer_cls(**init_kwargs)
    return writer.save(volume, path, **save_kwargs)


# Aliases matching the reference's ``dosma.load``/``dosma.save``.
load = read
save = write
