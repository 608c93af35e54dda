"""Scan-sequence base class (counterpart of ``dosma_tpu/scan_sequences/scans.py``).

``ScanSequence``: volumes, tissues, the reference DICOM header and metadata
overrides. ``NonTargetSequence`` (scans registered to a target) comes with
the registered scans: ROADMAP queue 1, item 7.
"""

from __future__ import annotations

import os
from time import localtime, strftime
from typing import Any, Sequence, Union

from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.scan_sequences.scan_io import ScanIOMixin
from dosma_tpu_torch.utils import env

__all__ = ["ScanSequence"]


class ScanSequence(ScanIOMixin):
    """Base class for scan sequences and their analysis."""

    NAME = ""
    __DEFAULT_SPLIT_BY__ = "EchoNumbers"

    def __init__(self, volumes: Union[MedicalVolume, Sequence[MedicalVolume]]):
        self.volumes = volumes
        self.series_number = None
        self._from_file_args = {}
        self.temp_path = os.path.join(
            env.temp_dir(), self.NAME, strftime("%Y-%m-%d-%H-%M-%S", localtime())
        )
        self.tissues = []
        self._metadata = {}
        # Pixel-stripped copy of the reference DICOM header, persisted by
        # ``ScanIOMixin.save`` so header-derived metadata (acquisition
        # parameters, private tags) survives a save/load round trip even
        # when volumes are externalized to a header-less format (NIfTI).
        # The reference loses this metadata on reload (its ``ref_dicom`` is
        # also a property over volume headers) — fixed here.
        self._ref_dicom_state = None

    def __validate_scan__(self) -> bool:
        return True

    def get_metadata(self, key: Any, default=None):
        """Metadata from scan dict or reference dicom (ref ``scans.py:88-116``)."""
        metadata = self._metadata.get(key, None)
        if metadata is None and self.ref_dicom is not None:
            metadata = self.ref_dicom[key].value if key in self.ref_dicom else None
        if metadata is None and default is False:
            raise KeyError(f"Metadata '{key}' not found")
        if metadata is None:
            return default
        return metadata

    def set_metadata(self, key: Any, value: Any):
        self._metadata[key] = value

    def get_dimensions(self):
        if isinstance(self.volumes, MedicalVolume):
            return self.volumes.shape
        return self.volumes[0].shape

    @property
    def ref_dicom(self):
        """First header of the first volume (ref ``scans.py:130-139``);
        falls back to the header snapshot persisted at save time when the
        reloaded volumes carry no DICOM headers."""
        vol = self.volumes[0] if isinstance(self.volumes, (list, tuple)) else self.volumes
        headers = vol.headers(flatten=True)
        if headers is not None:
            return headers[0]
        return getattr(self, "_ref_dicom_state", None)

    def __add_tissue__(self, new_tissue):
        if any(tissue.ID == new_tissue.ID for tissue in self.tissues):
            raise ValueError("Tissue already exists")
        self.tissues.append(new_tissue)

    def to(self, device):
        """Move all volumes to ``device`` (in place)."""
        if isinstance(self.volumes, MedicalVolume):
            self.volumes = self.volumes.to(device)
            return self
        self.volumes = [v.to(device) for v in self.volumes]
        return self

    @classmethod
    def cmd_line_actions(cls):
        """Subclasses return [(method, ActionWrapper)] for CLI exposure."""
        return []
