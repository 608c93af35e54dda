"""Tibial cartilage analytics (counterpart of
``dosma_tpu/tissues/tibial_cartilage.py``).

Superior/inferior by the center of mass of each (AP, slice) column,
anterior/central/posterior by thirds of each plateau's AP extent,
medial/lateral by the global center of mass; the axial unrolling is a
mean over each column. The region volume is built in numpy on the host;
the map is gathered at the mask's voxels on its own device, and only those
values cross to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.core.quant_vals import QuantitativeValueType
from dosma_tpu_torch.tissues._plot import save_quant_maps_and_tables
from dosma_tpu_torch.tissues.tissue import Tissue, column_means, largest_cc, unrolled_maps
from dosma_tpu_torch.utils import geometry_utils

__all__ = ["TibialCartilage"]

BOUNDS = {
    QuantitativeValueType.T2: 60.0,
    QuantitativeValueType.T1_RHO: 100.0,
    QuantitativeValueType.T2_STAR: 50.0,
}


class TibialCartilage(Tissue):
    """Tibial cartilage: S/I, A/C/P, M/L region analytics."""

    ID = 4
    STR_ID = "tc"
    FULL_NAME = "tibial cartilage"
    T1_EXPECTED = 1000  # ms
    _PREFETCH_FULL_MAP = False  # compressed analytics: masked gather on device

    _ANTERIOR_KEY = 0
    _POSTERIOR_KEY = 1
    _CENTRAL_KEY = 2
    _CORONAL_KEYS = [_ANTERIOR_KEY, _CENTRAL_KEY, _POSTERIOR_KEY]

    _MEDIAL_KEY = 0
    _LATERAL_KEY = 1
    _SAGITTAL_KEYS = [_MEDIAL_KEY, _LATERAL_KEY]

    _SUPERIOR_KEY = 0
    _INFERIOR_KEY = 1
    _TOTAL_AXIAL_KEY = -1

    def __init__(self, weights_dir=None, medial_to_lateral=None):
        super().__init__(weights_dir=weights_dir, medial_to_lateral=medial_to_lateral)
        self.regions_mask = None

    # ------------------------------------------------------------------
    def unroll_axial(self, quant_map):
        """Project the superior / inferior layers onto the axial plane: the
        mean over each (AP, slice) column (host arrays)."""
        mask = np.asarray(self.__mask__.volume)
        assert self.regions_mask is not None, "region_mask not initialized"
        quant_map = np.asarray(quant_map)
        if quant_map.shape != mask.shape:
            # The dense formulation (sel * mask * quant_map) raised on
            # mismatched grids; the compressed gather must too, not silently
            # index a wrong-strided volume.
            raise ValueError(
                f"quant_map shape {quant_map.shape} does not match mask shape {mask.shape}"
            )
        nz = np.nonzero(mask)
        vq = torch.from_numpy(mask[nz].astype(np.float64) * quant_map[nz])
        axial = torch.from_numpy(self.regions_mask[..., 0][nz].astype(np.int8))
        return self._unroll_axial_tables(vq, axial, nz)

    def _unroll_axial_tables(self, vq, axial, nz):
        """(total, superior, inferior) axial tables of the compressed values."""
        superior, inferior, total = column_means(
            vq, nz, (1, 2), self.__mask__.shape,
            (axial == self._SUPERIOR_KEY, axial == self._INFERIOR_KEY, None))
        return total, superior, inferior

    # ------------------------------------------------------------------
    def split_regions(self, base_map):
        """S/I by per-column local COM, A/C/P by per-plateau thirds, M/L by
        global COM (ref ``tibial_cartilage.py:83-160``; Black et al. ISMRM 2020)."""
        base_map = np.asarray(base_map)
        com = geometry_utils.center_of_mass(base_map)
        com_med_lat = int(np.ceil(com[2]))

        # M/L
        region_med_lat = np.zeros(base_map.shape)
        region_med_lat[:, :, :com_med_lat] = (
            self._MEDIAL_KEY if self.medial_to_lateral else self._LATERAL_KEY
        )
        region_med_lat[:, :, com_med_lat:] = (
            self._LATERAL_KEY if self.medial_to_lateral else self._MEDIAL_KEY
        )

        # S/I via local center of mass per (AP, slice) column.
        locs = base_map.sum(axis=0).nonzero()
        region_sup_inf = np.full(base_map.shape, self._INFERIOR_KEY, dtype=np.int64)
        if len(locs[0]):
            cols = base_map[:, locs[0], locs[1]]  # (SI, n_cols)
            si = np.arange(cols.shape[0])[:, None]
            w = cols.astype(np.float64)
            coms = np.ceil((si * w).sum(0) / w.sum(0)).astype(np.int64)
            # Each column superior above its center of mass (one assignment
            # of every column, not a Python loop over them).
            region_sup_inf[:, locs[0], locs[1]] = np.where(
                si < coms[None, :], self._SUPERIOR_KEY, self._INFERIOR_KEY)

        # A/C/P by per-plateau thirds of the AP extent.
        region_ant_post = np.zeros(base_map.shape)
        for plateau in [slice(0, com_med_lat), slice(com_med_lat, None)]:
            cum_ap = np.nonzero(base_map[..., plateau].sum(axis=(0, 2)))[0]
            if len(cum_ap) == 0:
                continue
            min_ap = np.min(cum_ap)
            ap_range = np.max(cum_ap) - min_ap
            thresh1 = int(np.ceil(min_ap + 1 / 3 * ap_range))
            thresh2 = int(np.ceil(min_ap + 2 / 3 * ap_range))
            region_ant_post[:, :thresh1, plateau] = self._ANTERIOR_KEY
            region_ant_post[:, thresh1:thresh2, plateau] = self._CENTRAL_KEY
            region_ant_post[:, thresh2:, plateau] = self._POSTERIOR_KEY

        self.regions_mask = np.stack(
            [region_sup_inf, region_ant_post, region_med_lat], axis=-1
        )

    # ------------------------------------------------------------------
    def quant_rows(self, quant_map, map_type):
        """The 18 regions' rows and the superior / inferior / total axial
        maps. The map is gathered at the mask's voxels where it lies; the
        region selections, statistics and tables are float64 reductions on
        the map's device, and only they cross to the host."""
        from dosma_tpu_torch.ops.analytics import summary

        self._check_quant_map(quant_map, map_type)
        assert self.regions_mask is not None, "region_mask not initialized"

        nz, codes, vq = self._masked_values(quant_map)
        axial_sel, sagittal_sel, coronal_sel = codes
        # NaN != 0 is True: NaN voxels stay selected (and are then left out
        # of the statistics), matching the dense ``vals[vals != 0]``.
        nonzero_sel = vq != 0
        finite = ~torch.isnan(vq)

        axial_names = ["superior", "inferior", "total"]
        coronal_names = ["medial", "lateral"]
        sagittal_names = ["anterior", "posterior", "central"]

        pd_header = ["Subject", "Location", "Side", "Region", "Mean", "Std", "Median"]
        pd_list = []
        for axial in [self._SUPERIOR_KEY, self._INFERIOR_KEY, self._TOTAL_AXIAL_KEY]:
            if axial == self._TOTAL_AXIAL_KEY:
                axial_match = (axial_sel == self._SUPERIOR_KEY) | (
                    axial_sel == self._INFERIOR_KEY
                )
            else:
                axial_match = axial_sel == axial
            for coronal in [self._MEDIAL_KEY, self._LATERAL_KEY]:
                for sagittal in [self._ANTERIOR_KEY, self._POSTERIOR_KEY, self._CENTRAL_KEY]:
                    sel = (
                        nonzero_sel
                        & axial_match
                        & (coronal_sel == coronal)
                        & (sagittal_sel == sagittal)
                    )
                    row = summary(vq[sel & finite])
                    pd_list.append(
                        [
                            self.pid,
                            axial_names[axial],
                            coronal_names[coronal],
                            sagittal_names[sagittal],
                            row["Mean"],
                            row["Std"],
                            row["Median"],
                        ]
                    )

        total, superior, inferior = self._unroll_axial_tables(vq, axial_sel, nz)
        maps = unrolled_maps(
            map_type, (("superior", superior), ("inferior", inferior), ("total", total)),
            ylabel="",
        )
        return pd_header, pd_list, maps

    def set_mask(self, mask: MedicalVolume, use_largest_ccs: bool = False):
        mask = mask.cpu()
        if use_largest_ccs:
            msk = np.asarray(largest_cc(np.asarray(mask.A), num=2), dtype=np.uint8)
        else:
            msk = np.asarray(mask.A, dtype=np.uint8)
        super().set_mask(mask._partial_clone(volume=msk))
        self.split_regions(np.asarray(self.__mask__.volume))

    def __save_quant_data__(self, dirpath):
        save_quant_maps_and_tables(dirpath, self.quant_vals, BOUNDS)
