"""NIfTI reader and writer of MedicalVolumes.

Counterpart of ``dosma_tpu/core/io/nifti_io.py``, backed by the port's copy
of the numpy NIfTI-1 codec (:mod:`dosma_tpu_torch.core.io.nifti`). Reading
rounds the affine at ``AFFINE_DECIMAL_PRECISION`` and the origin at
``SCANNER_ORIGIN_DECIMAL_PRECISION``, as ``dosma_tpu`` does.
"""

from __future__ import annotations

import os

import numpy as np

from dosma_tpu_torch.core.io.format_io import DataReader, DataWriter, ImageDataFormat
from dosma_tpu_torch.core.io.nifti import read_nifti, write_nifti
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.defaults import AFFINE_DECIMAL_PRECISION, SCANNER_ORIGIN_DECIMAL_PRECISION

__all__ = ["NiftiReader", "NiftiWriter"]


class NiftiReader(DataReader):
    """Load MedicalVolumes from ``.nii``/``.nii.gz`` files (host arrays)."""

    data_format_code = ImageDataFormat.nifti

    def __init__(self, mmap: bool = False):
        self.mmap = mmap

    def load(self, file_path: str, mmap: bool = None) -> MedicalVolume:
        file_path = str(file_path)
        if not os.path.isfile(file_path):
            raise FileNotFoundError(f"{file_path} not found")
        if not self.data_format_code.is_filetype(file_path):
            raise ValueError(f"{file_path} must be a NIfTI file (.nii/.nii.gz)")
        mmap = self.mmap if mmap is None else mmap
        arr, affine = read_nifti(file_path, mmap=mmap)
        affine = np.array(affine)
        affine[:3, :3] = np.round(affine[:3, :3], AFFINE_DECIMAL_PRECISION)
        affine[:3, 3] = np.round(affine[:3, 3], SCANNER_ORIGIN_DECIMAL_PRECISION)
        return MedicalVolume(arr, affine)

    read = DataReader.__call__


class NiftiWriter(DataWriter):
    """Save MedicalVolumes (host- or tensor-backed) to ``.nii``/``.nii.gz``."""

    data_format_code = ImageDataFormat.nifti

    def save(self, volume: MedicalVolume, file_path: str):
        file_path = str(file_path)
        if not self.data_format_code.is_filetype(file_path):
            raise ValueError(f"{file_path} must be a NIfTI file (.nii/.nii.gz)")
        dirname = os.path.dirname(file_path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        volume = volume.cpu()
        write_nifti(file_path, np.asarray(volume.volume), volume.affine)

    write = DataWriter.__call__
