"""Meniscus analytics (counterpart of ``dosma_tpu/tissues/meniscus.py``).

Anterior/posterior, superior/inferior and medial/lateral splits at the
global center of mass (``split_ml_only`` keeps medial/lateral alone), an
axial projection for the unrolled maps, and the rows of
``QuantitativeValue.metric_rows`` over a categorical mask: float64
reductions on the map's device, with no pandas. The map is gathered at the
mask's voxels where it lies, and the categorical mask and the projection
are built there too.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.core.quant_vals import QuantitativeValueType, T2
from dosma_tpu_torch.ops.analytics import flat_indices
from dosma_tpu_torch.tissues._plot import save_quant_maps_and_tables
from dosma_tpu_torch.tissues.tissue import Tissue, column_means, unrolled_maps
from dosma_tpu_torch.utils import geometry_utils

__all__ = ["Meniscus"]

BOUNDS = {
    QuantitativeValueType.T2: 60.0,
    QuantitativeValueType.T1_RHO: 100.0,
    QuantitativeValueType.T2_STAR: 50.0,
}


class Meniscus(Tissue):
    """Meniscus: COM-split regions + axial unrolling."""

    ID = 2
    STR_ID = "men"
    FULL_NAME = "meniscus"
    T1_EXPECTED = 1000  # ms
    _PREFETCH_FULL_MAP = False  # compressed analytics: masked gather on the map's device

    _ANTERIOR_KEY = 0
    _POSTERIOR_KEY = 1
    _CORONAL_KEYS = [_ANTERIOR_KEY, _POSTERIOR_KEY]

    _MEDIAL_KEY = 0
    _LATERAL_KEY = 1
    _SAGGITAL_KEYS = [_MEDIAL_KEY, _LATERAL_KEY]

    _SUPERIOR_KEY = 0
    _INFERIOR_KEY = 1
    _TOTAL_AXIAL_KEY = -1

    def __init__(self, weights_dir: str = None, medial_to_lateral: bool = None,
                 split_ml_only: bool = False):
        super().__init__(weights_dir=weights_dir, medial_to_lateral=medial_to_lateral)
        self.split_ml_only = split_ml_only
        self.regions_mask = None

    def unroll_axial(self, quant_map: np.ndarray):
        """Project the superior / inferior layers onto the axial plane: the
        mean over each (AP, slice) column of the masked voxels (host arrays)."""
        mask = np.asarray(self.__mask__.volume)
        assert self.regions_mask is not None, "region_mask not initialized"
        nz = np.nonzero(mask)
        vq = torch.from_numpy(mask[nz].astype(np.float64) * np.asarray(quant_map)[nz])
        sup_inf = torch.from_numpy(self.regions_mask[..., 0][nz].astype(np.int8))
        return self._unroll_axial_tables(vq, sup_inf, nz)

    def _unroll_axial_tables(self, vq, sup_inf, nz):
        """(total, superior, inferior) axial tables of the compressed values."""
        superior, inferior, total = column_means(
            vq, nz, (1, 2), self.__mask__.shape,
            (sup_inf == self._SUPERIOR_KEY, sup_inf == self._INFERIOR_KEY, None))
        return total, superior, inferior

    def split_regions(self, base_map):
        """Global-COM splits along all three axes (ref ``meniscus.py:101-132``)."""
        base_map = np.asarray(base_map)
        com = geometry_utils.center_of_mass(base_map)
        com_sup_inf = int(np.ceil(com[0]))
        com_ant_post = int(np.ceil(com[1]))
        com_med_lat = int(np.ceil(com[2]))

        region_sup_inf = np.zeros(base_map.shape)
        region_sup_inf[com_sup_inf:, :, :] = self._INFERIOR_KEY

        region_ant_post = np.zeros(base_map.shape)
        region_ant_post[:, com_ant_post:, :] = self._POSTERIOR_KEY

        region_med_lat = np.zeros(base_map.shape)
        region_med_lat[:, :, :com_med_lat] = (
            self._MEDIAL_KEY if self.medial_to_lateral else self._LATERAL_KEY
        )
        region_med_lat[:, :, com_med_lat:] = (
            self._LATERAL_KEY if self.medial_to_lateral else self._MEDIAL_KEY
        )

        self.regions_mask = np.stack(
            [region_sup_inf, region_ant_post, region_med_lat], axis=-1
        )

    def quant_rows(self, quant_map: MedicalVolume, map_type):
        """One row per (axial, coronal, sagittal) category and a total row,
        from ``T2.metric_rows`` over the categorical mask, and the
        superior / inferior / total axial maps. The categorical mask is
        built at the mask's voxels on the map's device, where the map is
        gathered and reduced."""
        self._check_quant_map(quant_map, map_type)
        assert self.regions_mask is not None, "region_mask not initialized"

        nz, codes, vq = self._masked_values(quant_map)
        axial_region, coronal_region, sagittal_region = codes

        axial_categories = [
            (self._SUPERIOR_KEY, "superior"), (self._INFERIOR_KEY, "inferior"), (-1, "total"),
        ]
        coronal_categories = [
            (self._ANTERIOR_KEY, "anterior"), (self._POSTERIOR_KEY, "posterior"), (-1, "total"),
        ]
        sagittal_categories = [(self._MEDIAL_KEY, "medial"), (self._LATERAL_KEY, "lateral")]
        if self.split_ml_only:
            axial_categories = [x for x in axial_categories if x[0] == -1]
            coronal_categories = [x for x in coronal_categories if x[0] == -1]

        # Each voxel takes the last category that contains it, as the dense
        # reference assigns them in this order (so the "total" categories
        # take every voxel). uint8 labels: at most 12.
        labels_nz = torch.zeros(len(nz[0]), dtype=torch.uint8, device=vq.device)
        labels = {}
        for idx, ((axial, a_name), (coronal, c_name), (sagittal, s_name)) in enumerate(
            itertools.product(axial_categories, coronal_categories, sagittal_categories)
        ):
            label = idx + 1
            sel = sagittal_region == sagittal
            if axial != -1:
                sel &= axial_region == axial
            if coronal != -1:
                sel &= coronal_region == coronal
            labels_nz[sel] = label
            labels[label] = f"{a_name}-{c_name}-{s_name}"
        shape = self.__mask__.shape
        categorical = torch.zeros(int(np.prod(shape)), dtype=torch.uint8, device=vq.device)
        categorical[torch.from_numpy(flat_indices(nz, shape)).to(vq.device)] = labels_nz

        t2 = T2(quant_map)
        categorical_mv = MedicalVolume(categorical.reshape(shape), affine=quant_map.affine)
        rows = t2.metric_rows(categorical_mv, labels=labels, bounds=(0, np.inf), closed="neither")
        header = ["Subject", *rows[0]]
        rows = [[self.pid, *row.values()] for row in rows]

        total, superior, inferior = self._unroll_axial_tables(vq, axial_region, nz)
        maps = unrolled_maps(
            map_type, (("superior", superior), ("inferior", inferior), ("total", total)),
            ylabel="Angle (binned)",
        )
        return header, rows, maps

    def set_mask(self, mask: MedicalVolume):
        mask = mask.cpu()
        msk = np.asarray(mask.A, dtype=np.uint8)
        super().set_mask(mask._partial_clone(volume=msk))
        self.split_regions(np.asarray(self.__mask__.volume))

    def __save_quant_data__(self, dirpath):
        save_quant_maps_and_tables(dirpath, self.quant_vals, BOUNDS)
