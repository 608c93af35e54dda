"""I/O format templates (counterpart of ``dosma_tpu/core/io/format_io.py``;
a re-design of DOSMA's ``dosma/core/io/format_io.py``).

``ImageDataFormat`` enum with extension matching (ref ``:32-94``), abstract
``DataReader``/``DataWriter`` with ``__call__`` aliases (ref ``:146-201``),
and the ``_StateMixin`` state_dict/load_state_dict protocol (ref ``:97-143``).
"""

from __future__ import annotations

import enum
import os
from abc import ABC
from typing import Any, Collection, Dict

__all__ = ["ImageDataFormat", "DataReader", "DataWriter"]


class ImageDataFormat(enum.Enum):
    """Supported image data formats and their file extensions."""

    nifti = 1, ("nii", "nii.gz")
    dicom = 2, ("dcm", "ima")

    def __new__(cls, key_code, extensions):
        obj = object.__new__(cls)
        obj._value_ = key_code
        obj.extensions = extensions
        return obj

    def is_filetype(self, file_path: str) -> bool:
        """True if ``file_path`` matches one of this format's extensions."""
        file_path = str(file_path).lower()
        return any(file_path.endswith(f".{ext}") for ext in self.extensions)

    @classmethod
    def get_image_data_format(cls, file_or_dir_path: str) -> "ImageDataFormat":
        """Infer format from a path. Directories (or extension-less paths that
        are not nifti/dicom files) default to dicom (ref ``format_io.py:66-94``)."""
        for fmt in cls:
            if fmt.is_filetype(file_or_dir_path):
                return fmt
        # Directories or paths without known extension → dicom dir convention.
        path = str(file_or_dir_path)
        if os.path.isdir(path) or not os.path.splitext(path)[1]:
            return cls.dicom
        raise ValueError(f"Unknown data format for {file_or_dir_path}")


class _StateMixin:
    """Serialize reader/writer configuration (ref ``format_io.py:97-143``)."""

    def __serializable_variables__(self) -> Collection[str]:
        return self.__dict__.keys()

    def state_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__serializable_variables__()}

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = False):
        if strict:
            unknown = set(state_dict) - set(self.__serializable_variables__())
            if unknown:
                raise ValueError(f"Unknown keys in state_dict: {unknown}")
        for k, v in state_dict.items():
            setattr(self, k, v)
        return self


class DataReader(_StateMixin, ABC):
    """Abstract reader. Subclasses define ``data_format_code`` and ``load``."""

    data_format_code: ImageDataFormat = None

    def load(self, path, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.load(*args, **kwargs)

    read = __call__


class DataWriter(_StateMixin, ABC):
    """Abstract writer. Subclasses define ``data_format_code`` and ``save``."""

    data_format_code: ImageDataFormat = None

    def save(self, volume, path, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.save(*args, **kwargs)

    write = __call__
