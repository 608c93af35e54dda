"""Patellar cartilage analytics (counterpart of
``dosma_tpu/tissues/patellar_cartilage.py``).

A flat tissue: deep/superficial by the center of mass of each column in the
A/P direction, medial/lateral by the global center of mass, and a coronal
projection for the unrolled maps. The region volume is built in numpy on
the host; the map is gathered at the mask's voxels where it lies, and the
statistics and tables are float64 reductions there (``dosma_tpu`` reads
the whole map and reduces its float32 product in float32).
"""

from __future__ import annotations

import itertools
import warnings

import numpy as np
import torch

from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.core.quant_vals import QuantitativeValueType
from dosma_tpu_torch.tissues._plot import save_quant_maps_and_tables
from dosma_tpu_torch.tissues.tissue import Tissue, column_means, largest_cc, unrolled_maps
from dosma_tpu_torch.utils import geometry_utils

__all__ = ["PatellarCartilage"]

BOUNDS = {
    QuantitativeValueType.T2: 80.0,
    QuantitativeValueType.T1_RHO: 100.0,
    QuantitativeValueType.T2_STAR: 80.0,
}


class PatellarCartilage(Tissue):
    """Patellar cartilage: deep/superficial + medial/lateral analytics."""

    ID = 3
    STR_ID = "pc"
    FULL_NAME = "patellar cartilage"
    T1_EXPECTED = 1000  # ms
    _PREFETCH_FULL_MAP = False  # compressed analytics: masked gather on the map's device

    _ANTERIOR_KEY = 0
    _POSTERIOR_KEY = 1
    _CORONAL_KEYS = [_ANTERIOR_KEY, _POSTERIOR_KEY]

    _MEDIAL_KEY = 0
    _LATERAL_KEY = 1
    _SAGITTAL_KEYS = [_MEDIAL_KEY, _LATERAL_KEY]

    _REGION_DEEP_KEY = 0
    _REGION_SUPERFICIAL_KEY = 1
    _TOTAL_AXIAL_KEY = -1

    def __init__(self, weights_dir: str = None, medial_to_lateral: bool = None):
        super().__init__(weights_dir=weights_dir, medial_to_lateral=medial_to_lateral)
        self.regions_mask = None

    def unroll_coronal(self, quant_map: np.ndarray):
        """Project onto the coronal plane (flat tissue): the mean over each
        (SI, AP) column of the masked voxels (host arrays)."""
        mask = np.asarray(self.__mask__.volume)
        assert self.regions_mask is not None, "region_mask not initialized"
        nz = np.nonzero(mask)
        vq = torch.from_numpy(mask[nz].astype(np.float64) * np.asarray(quant_map)[nz])
        deep_sup = torch.from_numpy(self.regions_mask[..., 0][nz].astype(np.int8))
        return self._unroll_coronal_tables(vq, deep_sup, nz)

    def _unroll_coronal_tables(self, vq, deep_sup, nz):
        """(total, superficial, deep) coronal tables of the compressed values."""
        superficial, deep, total = column_means(
            vq, nz, (0, 1), self.__mask__.shape,
            (deep_sup == self._REGION_SUPERFICIAL_KEY, deep_sup == self._REGION_DEEP_KEY, None))
        return total, superficial, deep

    def split_regions(self, base_map):
        """Deep/superficial by per-column A/P local COM; M/L by global COM
        (ref ``patellar_cartilage.py:92-131``)."""
        base_map = np.asarray(base_map)
        if np.sum(base_map) == 0:
            warnings.warn(f"No mask for `{self.FULL_NAME}` was found.")

        locs = base_map.sum(axis=1).nonzero()
        region_sup_deep = np.full(base_map.shape, self._REGION_DEEP_KEY, dtype=np.int64)
        if len(locs[0]):
            cols = base_map[locs[0], :, locs[1]]  # (n_cols, AP)
            ap = np.arange(cols.shape[1])[None, :]
            w = cols.astype(np.float64)
            coms = np.ceil((ap * w).sum(1) / w.sum(1)).astype(np.int64)
            # Each column superficial before its center of mass along A/P
            # (one assignment of every column, not a Python loop over them).
            region_sup_deep[locs[0], :, locs[1]] = np.where(
                ap < coms[:, None], self._REGION_SUPERFICIAL_KEY, self._REGION_DEEP_KEY)

        midpoint_ml = int(np.ceil(geometry_utils.center_of_mass(base_map)[2])) if base_map.sum() else 0
        region_med_lat = np.full(base_map.shape, self._LATERAL_KEY, dtype=np.int64)
        medial_span = slice(0, midpoint_ml) if self.medial_to_lateral else slice(midpoint_ml, None)
        region_med_lat[:, :, medial_span] = self._MEDIAL_KEY

        self.regions_mask = np.stack([region_sup_deep, region_med_lat], axis=-1)

    def quant_rows(self, quant_map, map_type):
        """The 6 regions' rows (deep / superficial / total x medial /
        lateral) and the superficial / deep / total coronal maps. The map is
        gathered at the mask's voxels where it lies; the statistics and
        tables are float64 reductions on the map's device (``dosma_tpu``
        reduces its float32 product in float32)."""
        from dosma_tpu_torch.ops.analytics import summary

        self._check_quant_map(quant_map, map_type)
        assert self.regions_mask is not None, "region_mask not initialized"

        nz, codes, vq = self._masked_values(quant_map)
        deep_superficial, med_lat = codes
        nonzero = vq != 0
        finite = ~torch.isnan(vq)

        axial_names = ["deep", "superficial", "total"]
        sagittal_names = ["medial", "lateral"]

        pd_header = ["Subject", "Location", "Condyle", "Mean", "Std", "Median"]
        pd_list = []
        for axial, sagittal in itertools.product(
            [self._REGION_SUPERFICIAL_KEY, self._REGION_DEEP_KEY, self._TOTAL_AXIAL_KEY],
            [self._MEDIAL_KEY, self._LATERAL_KEY],
        ):
            if axial == self._TOTAL_AXIAL_KEY:
                axial_map = (deep_superficial == self._REGION_SUPERFICIAL_KEY) | (
                    deep_superficial == self._REGION_DEEP_KEY
                )
            else:
                axial_map = deep_superficial == axial
            row = summary(vq[nonzero & finite & axial_map & (med_lat == sagittal)])
            pd_list.append(
                [
                    self.pid,
                    axial_names[axial],
                    sagittal_names[sagittal],
                    row["Mean"],
                    row["Std"],
                    row["Median"],
                ]
            )

        total, superficial, deep = self._unroll_coronal_tables(vq, deep_superficial, nz)
        maps = unrolled_maps(
            map_type, (("superficial", superficial), ("deep", deep), ("total", total)),
            ylabel="Angle (binned)",
        )
        return pd_header, pd_list, maps

    def set_mask(self, mask: MedicalVolume, use_largest_cc: bool = True):
        mask = mask.cpu()
        if use_largest_cc:
            msk = np.asarray(largest_cc(np.asarray(mask.A)), dtype=np.uint8)
        else:
            msk = np.asarray(mask.A, dtype=np.uint8)
        super().set_mask(mask._partial_clone(volume=msk))
        self.split_regions(np.asarray(self.__mask__.volume))

    def __save_quant_data__(self, dirpath):
        save_quant_maps_and_tables(dirpath, self.quant_vals, BOUNDS)
