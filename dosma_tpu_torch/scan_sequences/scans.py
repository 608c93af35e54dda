"""Scan-sequence base classes (counterpart of ``dosma_tpu/scan_sequences/scans.py``).

``ScanSequence``: volumes, tissues, the reference DICOM header and metadata
overrides. ``NonTargetSequence``: scans registered to a target scan (the
inter-registration flow, the reload of inter-registered volumes, the
Gaussian dilation of the target mask).
"""

from __future__ import annotations

import logging
import os
import re
from abc import abstractmethod
from time import localtime, strftime
from typing import Any, Sequence, Union

import numpy as np
import torch

from dosma_tpu_torch.core.io import format_io_utils as fio_utils
from dosma_tpu_torch.core.io.nifti_io import NiftiReader
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.scan_sequences.scan_io import ScanIOMixin
from dosma_tpu_torch.utils import env, io_utils
from dosma_tpu_torch.utils.natsort import natsorted

__all__ = ["ScanSequence", "NonTargetSequence"]

_logger = logging.getLogger(__name__)


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


class NonTargetSequence(ScanSequence):
    """Scans that must be registered (inter-registered) to a target scan."""

    @abstractmethod
    def interregister(self, target_path: str, mask_path: str = None):
        """Register this scan to the target scan."""
        pass  # pragma: no cover

    def _interregister_to_target(
        self,
        target_path: str,
        target_mask_path: str,
        sort_values: Sequence[float],
        base_position: str,
    ):
        """The inter-registration flow shared by CubeQuant and Cones, which
        differ only in the volume that anchors it:

        1. order the volumes by ``sort_values`` (echo or spin-lock times);
        2. register the highest-SNR anchor (``base_position`` "first" or
           "last") to the target, rigid then affine, the second stage masked
           by the Gaussian-dilated target mask when one is given;
        3. warp every other volume under the anchor's transform;
        4. restore the original order.

        On one grid the chain, the anchor's warp and the others' warps run
        on the compute device as one :func:`register_chain` call, the warps
        one launch of the warp kernel; only the 4x4 matrices come back, as
        JSON transform files that :func:`apply_warp` reads. Volumes on
        several grids take ``register`` and ``apply_warp``.
        """
        from dosma_tpu_torch import file_constants as fc
        from dosma_tpu_torch.core.registration import (
            _load_stage_params,
            _load_volume,
            _save_transform_file,
            apply_warp,
            register,
        )
        from dosma_tpu_torch.ops.registration import register_chain

        idxs = list(np.argsort(sort_values))
        ordered = [self.volumes[i] for i in idxs]

        out_path = os.path.join(self.temp_path, "interregistered")
        os.makedirs(out_path, exist_ok=True)
        _logger.info(f"Interregistering... Target: {target_path}")

        if target_mask_path:
            target_mask_path = self.__dilate_mask__(target_mask_path, out_path)
            stages = [
                fc.ELASTIX_RIGID_INTERREGISTER_PARAMS_FILE,
                fc.ELASTIX_AFFINE_INTERREGISTER_PARAMS_FILE,
            ]
            use_mask = [False, True]
        else:
            stages = [fc.ELASTIX_RIGID_PARAMS_FILE, fc.ELASTIX_AFFINE_PARAMS_FILE]
            use_mask = None

        anchor_idx = 0 if base_position == "first" else len(ordered) - 1
        anchor = ordered[anchor_idx]
        others = [v for i, v in enumerate(ordered) if i != anchor_idx]

        target_mv = _load_volume(target_path)
        same_grid = all(
            tuple(v.shape[:3]) == tuple(anchor.shape[:3]) and np.allclose(v.affine, anchor.affine)
            for v in others
        )

        if not same_grid:
            (spec,), (warped_anchor,) = register(
                target_path, anchor, parameters=stages, output_path=out_path,
                sequential=True, collate=True, return_volumes=True,
                target_mask=target_mask_path, use_mask=use_mask, rtype=tuple,
            )
            # A list: same-grid volumes among them warp as one stack.
            warped_others = list(apply_warp(others, spec.transform)) if others else []
        else:
            stage_cfgs = [_load_stage_params(p) for p in stages]
            mask_arr = None
            if target_mask_path:
                mask_arr = _load_volume(target_mask_path).reformat_as(target_mv).volume

            Ms, warped, warped_extras, _info = register_chain(
                target_mv.volume, target_mv.affine, anchor.volume, anchor.affine,
                stage_cfgs, fixed_mask=mask_arr, use_mask=use_mask,
                extras=[v.volume for v in others],
            )
            # The transform files, in the layout register writes.
            reg_dir = os.path.join(out_path, "moving-0")
            for s_idx, cfg in enumerate(stage_cfgs):
                S = Ms[s_idx] if s_idx == 0 else np.linalg.inv(Ms[s_idx - 1]) @ Ms[s_idx]
                _save_transform_file(
                    os.path.join(reg_dir, f"TransformParameters.{s_idx}.json"),
                    ("matrix", S), cfg, target_mv, anchor,
                )
            warped_anchor = MedicalVolume(warped, target_mv.affine)
            warped_others = [MedicalVolume(warped_extras[i], target_mv.affine)
                             for i in range(len(others))]

        if base_position == "first":
            reg_vols = [warped_anchor] + warped_others
        else:
            reg_vols = warped_others + [warped_anchor]

        # Undo the sort.
        restore = {orig: pos for pos, orig in enumerate(idxs)}
        self.volumes = [reg_vols[restore[i]] for i in range(len(reg_vols))]

    def __load_interregistered_files__(self, interregistered_dirpath: str):
        """The inter-registered sub-volumes ``<idx>.nii.gz`` of a directory,
        by index."""
        _logger.info("Loading interregistered files")
        if "interregistered" not in interregistered_dirpath:
            raise ValueError(f"Invalid path for loading {self.NAME} interregistered files")

        subfiles = natsorted(os.listdir(interregistered_dirpath))
        if len(subfiles) == 0:
            raise ValueError("No interregistered files found")

        indices = []
        subvolumes = []
        nifti_reader = NiftiReader()
        for subfile in subfiles:
            subfile_nums = re.findall(r"[-+]?\d*\.\d+|\d+", subfile)
            if len(subfile_nums) == 0:
                raise ValueError(f"{subfile} is not an interregistered '.gz.nii' file.")
            indices.append(int(subfile_nums[0]))
            subvolumes.append(nifti_reader.load(os.path.join(interregistered_dirpath, subfile)))

        return {idx: sv for idx, sv in zip(indices, subvolumes)}

    def __dilate_mask__(
        self,
        mask_path: str,
        temp_path: str,
        dil_rate: float = None,
        dil_threshold: float = None,
    ) -> str:
        """Gaussian-blur dilation of a binary mask (a path or a volume),
        written as NIfTI; returns its path. scipy filters on the host, so a
        mask on a card is copied to the host once."""
        import scipy.ndimage as sni

        if dil_rate is None:
            dil_rate = preferences.mask_dilation_rate
        if dil_threshold is None:
            dil_threshold = preferences.mask_dilation_threshold
        if dil_threshold < 0 or dil_threshold > 1:
            raise ValueError("'dil_threshold' must be in range [0, 1]")

        if isinstance(mask_path, MedicalVolume):
            mask = mask_path
        elif os.path.isfile(mask_path):
            mask = fio_utils.generic_load(mask_path, expected_num_volumes=1)
        else:
            raise FileNotFoundError(f"File {mask_path} not found")

        volume = mask.volume
        if isinstance(volume, torch.Tensor):
            volume = volume.cpu().numpy()
        dilated_mask = (
            sni.gaussian_filter(np.asarray(volume, dtype=np.float32), sigma=dil_rate)
            > dil_threshold
        )
        fixed_mask = np.asarray(dilated_mask, dtype=np.int8)
        fixed_mask_filepath = os.path.join(io_utils.mkdirs(temp_path), "dilated-mask.nii.gz")
        MedicalVolume(fixed_mask, affine=mask.affine).save_volume(fixed_mask_filepath)
        return fixed_mask_filepath
