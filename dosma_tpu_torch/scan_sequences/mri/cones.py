"""UTE-Cones (T2*) scan sequence (counterpart of
``dosma_tpu/scan_sequences/mri/cones.py``).

Four echoes; the LAST echo anchors the inter-registration, the transform
is reused on the earlier echoes; a monoexponential T2* fit with bounds
(0, inf).
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import numpy as np

from dosma_tpu_torch.core import quant_vals as qv
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.scan_sequences.mri._common import (
    interregister_action,
    monoexp_qv_fit,
    qmap_action,
    times_from_headers,
)
from dosma_tpu_torch.scan_sequences.scans import NonTargetSequence
from dosma_tpu_torch.tissues.tissue import Tissue

__all__ = ["Cones"]

_logger = logging.getLogger(__name__)

_T2STAR_BOUNDS = (0, np.inf)
_DECIMALS = 3


class Cones(NonTargetSequence):
    """Ultra-short echo time Cones T2*-weighted sequence."""

    NAME = "cones"

    def __init__(self, volumes, echo_times: Sequence[float] = None):
        super().__init__(volumes)
        self.echo_times = (
            echo_times if echo_times is not None
            else times_from_headers(self.volumes, "echo_times")
        )

    def interregister(self, target_path: str, target_mask_path: str = None):
        """Register to a target scan, anchored on the LAST (highest-SNR) echo."""
        self._interregister_to_target(
            target_path, target_mask_path, self.echo_times, base_position="last"
        )

    def generate_t2_star_map(self, tissue: Tissue = None, mask_path: str = None,
                             num_workers: int = 0):
        """Monoexponential T2* map, bounds (0, inf)."""
        return monoexp_qv_fit(
            self.echo_times, self.volumes, qv.T2Star, _T2STAR_BOUNDS, _DECIMALS,
            tissue=tissue, mask_path=mask_path, num_workers=num_workers,
        )

    def _save(self, metadata, save_dir, fname_fmt=None, **kwargs):
        fmt = {MedicalVolume: "echo-{}", **(fname_fmt or {})}
        return super()._save(metadata, save_dir, fname_fmt=fmt, **kwargs)

    @classmethod
    def from_dict(cls, data, force: bool = False) -> "Cones":
        interregistered_dirpath = None
        if "subvolumes" in data:
            interregistered_dirpath = os.path.dirname(data.pop("subvolumes")[0])
        scan = super().from_dict(data, force=force)
        if interregistered_dirpath is not None:
            subvolumes = scan.__load_interregistered_files__(interregistered_dirpath)
            scan.volumes = [subvolumes[k] for k in sorted(subvolumes.keys())]
        return scan

    @classmethod
    def cmd_line_actions(cls):
        return [
            interregister_action(cls.interregister),
            qmap_action(
                cls.generate_t2_star_map,
                "generate T2-star map",
                aliases=["t2_star"],
                mask_help="Mask used for fitting select voxels - in nifti format (.nii.gz)",
            ),
        ]
