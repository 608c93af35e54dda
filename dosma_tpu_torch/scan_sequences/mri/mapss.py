"""MAPSS scan sequence: T1ρ and T2 from one 7-echo acquisition (counterpart
of ``dosma_tpu/scan_sequences/mri/mapss.py``).

Echoes 1-6 are each registered to echo 0 and rebuilt on their original
affines and headers; T1ρ comes from echoes 0-3 (bounds (0, 500)), T2 from
echoes [0, 4, 5, 6] (bounds (0, 100)), each sorted by echo time first.
"""

from __future__ import annotations

import logging
import os
from copy import deepcopy
from typing import List, Sequence

from dosma_tpu_torch import file_constants as fc
from dosma_tpu_torch.core import quant_vals as qv
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.core.registration import register
from dosma_tpu_torch.scan_sequences.mri._common import (
    intraregister_action,
    monoexp_qv_fit,
    qmap_action,
    times_from_headers,
)
from dosma_tpu_torch.scan_sequences.scans import ScanSequence
from dosma_tpu_torch.tissues.tissue import Tissue

__all__ = ["Mapss"]

_logger = logging.getLogger(__name__)

_NUM_ECHOES = 7
_T1RHO_BOUNDS = (0, 500)
_T2_BOUNDS = (0, 100)
_DECIMALS = 3


class Mapss(ScanSequence):
    """3D MAPSS SPGR sequence (4 spin-lock + 3 TE volumes)."""

    NAME = "mapss"

    def __init__(self, volumes: Sequence[MedicalVolume], echo_times: Sequence[float] = None):
        if not isinstance(volumes, (list, tuple)):
            raise ValueError("`volumes` must be sequence of MedicalVolumes.")
        super().__init__(volumes)
        self.echo_times = (
            echo_times if echo_times is not None
            else times_from_headers(self.volumes, "echo_times")
        )

    def __validate_scan__(self):
        return len(self.volumes) == _NUM_ECHOES

    def __intraregister__(self, volumes: List[MedicalVolume]):
        """Register echoes 1..6 to echo 0 (one register call, one warp
        launch for the six) and rebuild them on the originals' affines and
        headers. Copies of card volumes stay on the card."""
        if not isinstance(volumes, list) or len(volumes) != _NUM_ECHOES:
            raise TypeError("`volumes` must be of type List[MedicalVolume]")

        _logger.info("Intraregistering...")
        out_path = os.path.join(self.temp_path, "intraregistered")

        target = volumes[0]
        _, warped_all = register(
            target,
            volumes[1:],
            fc.ELASTIX_AFFINE_PARAMS_FILE,
            output_path=out_path,
            return_volumes=True,
            rtype=tuple,
            save_volumes=False,
        )
        intraregistered = [deepcopy(target)]
        for echo_index, warped in zip(range(1, len(volumes)), warped_all):
            intraregistered.append(
                MedicalVolume(
                    volume=warped.volume,
                    affine=volumes[echo_index].affine,
                    headers=deepcopy(volumes[echo_index].headers()),
                )
            )

        self.volumes = intraregistered

    def intraregister(self):
        """Intra-register the echoes."""
        self.__intraregister__(self.volumes)

    def _fit_echo_subset(self, qv_type, echo_inds, bounds, tissue, mask_path, num_workers):
        """Monoexponential fit over a subset of echoes, sorted by echo time."""
        pairs = sorted(((self.echo_times[i], self.volumes[i]) for i in echo_inds),
                       key=lambda p: p[0])
        return monoexp_qv_fit(
            [t for t, _ in pairs], [v for _, v in pairs],
            qv_type, bounds, _DECIMALS,
            tissue=tissue, mask_path=mask_path, num_workers=num_workers,
        )

    def generate_t1_rho_map(self, tissue: Tissue = None, mask_path: str = None,
                            num_workers: int = 0):
        """T1ρ from echoes 0-3."""
        return self._fit_echo_subset(
            qv.T1Rho, range(4), _T1RHO_BOUNDS, tissue, mask_path, num_workers
        )

    def generate_t2_map(self, tissue: Tissue = None, mask_path: str = None,
                        num_workers: int = 0):
        """T2 from echoes [0, 4, 5, 6]."""
        return self._fit_echo_subset(
            qv.T2, [0, 4, 5, 6], _T2_BOUNDS, tissue, mask_path, num_workers
        )

    def _save(self, metadata, save_dir, fname_fmt=None, **kwargs):
        fmt = {MedicalVolume: "echo-{}", **(fname_fmt or {})}
        return super()._save(metadata, save_dir, fname_fmt=fmt, **kwargs)

    @classmethod
    def cmd_line_actions(cls):
        return [
            intraregister_action(cls.intraregister),
            qmap_action(
                cls.generate_t1_rho_map,
                "generate T1-rho map using monoexponential fit",
                aliases=["t1_rho"],
            ),
            qmap_action(
                cls.generate_t2_map,
                "generate T2 map using monoexponential fit",
                aliases=["t2"],
            ),
        ]
