"""CubeQuant (T1ρ) scan sequence (counterpart of
``dosma_tpu/scan_sequences/mri/cube_quant.py``).

Four spin-lock volumes: intra-registration of the later spin locks to the
first (highest-SNR) one, inter-registration to a target with the transform
reused on the other spin locks, and a monoexponential T1ρ fit (bounds
(0, 500) ms, polyfit seed, 3 decimals). For volumes on a card, each
registration's final warp is one launch of the warp kernel and the fit one
launch of the monoexponential kernel.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import numpy as np

from dosma_tpu_torch import file_constants as fc
from dosma_tpu_torch.core import quant_vals as qv
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.core.registration import register
from dosma_tpu_torch.scan_sequences.mri._common import (
    interregister_action,
    intraregister_action,
    monoexp_qv_fit,
    qmap_action,
    times_from_headers,
)
from dosma_tpu_torch.scan_sequences.scans import NonTargetSequence
from dosma_tpu_torch.tissues.tissue import Tissue

__all__ = ["CubeQuant"]

_logger = logging.getLogger(__name__)

_T1RHO_BOUNDS = (0, 500)
_DECIMALS = 3


class CubeQuant(NonTargetSequence):
    """CubeQuant 3D FSE T1ρ-weighted sequence (4 spin-lock times)."""

    NAME = "cubequant"

    def __init__(self, volumes: Sequence[MedicalVolume], spin_lock_times: Sequence[float] = None):
        super().__init__(volumes=volumes)
        self.spin_lock_times = (
            spin_lock_times if spin_lock_times is not None
            else times_from_headers(self.volumes, "spin_lock_times")
        )

    # ------------------------------------------------------------------
    def intraregister(self):
        """Register every later spin-lock volume to the first (highest
        SNR) spin lock."""
        self.__intraregister__()

    def __intraregister__(self):
        order = np.argsort(self.spin_lock_times)
        by_snr = [self.volumes[i] for i in order]

        _logger.info("Intraregistering...")
        # One register call for all moving spin locks: their chains in turn,
        # one warp launch for the stack; no result files (transforms only).
        _, warped = register(
            by_snr[0],
            by_snr[1:],
            fc.ELASTIX_AFFINE_PARAMS_FILE,
            os.path.join(self.temp_path, "intraregister"),
            return_volumes=True,
            rtype=tuple,
            save_volumes=False,
        )

        # Registered volumes carry the anchor's grid and the headers of the
        # originals they replace.
        registered = [by_snr[0]] + [
            reg._partial_clone(volume=False, headers=orig.headers())
            for reg, orig in zip(warped, by_snr[1:])
        ]

        undo = {int(src): dst for dst, src in enumerate(order)}
        self.volumes = [registered[undo[i]] for i in range(len(registered))]

    # ------------------------------------------------------------------
    def interregister(self, target_path: str, target_mask_path: str = None):
        """Register to a target scan, anchored on the FIRST (highest-SNR)
        spin lock."""
        self._interregister_to_target(
            target_path, target_mask_path, self.spin_lock_times, base_position="first"
        )

    # ------------------------------------------------------------------
    def generate_t1_rho_map(self, tissue: Tissue = None, mask_path: str = None,
                            num_workers: int = 0):
        """Monoexponential T1ρ map, bounds (0, 500) ms."""
        return monoexp_qv_fit(
            self.spin_lock_times, self.volumes, qv.T1Rho, _T1RHO_BOUNDS, _DECIMALS,
            tissue=tissue, mask_path=mask_path, num_workers=num_workers,
        )

    # ------------------------------------------------------------------
    def _save(self, metadata, save_dir: str, fname_fmt=None, **kwargs):
        fmt = {MedicalVolume: "echo-{}", **(fname_fmt or {})}
        return super()._save(metadata, save_dir, fname_fmt=fmt, **kwargs)

    @classmethod
    def from_dict(cls, data, force: bool = False) -> "CubeQuant":
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
            intraregister_action(cls.intraregister),
            interregister_action(cls.interregister),
            qmap_action(
                cls.generate_t1_rho_map,
                "generate T1-rho map",
                aliases=["t1_rho"],
                mask_help="Mask used for fitting select voxels - in nifti format (.nii.gz)",
            ),
        ]
